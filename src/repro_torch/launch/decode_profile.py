"""Where a serving decode step's time goes: host issue, wall, device busy.

Draws a model from a seed (the published width with ``--full``), prefills a
batch of random prompts as :func:`repro_torch.launch.serve.serve` does, then
times greedy decode steps on the card three ways:

- *host ms a step*: the host clock from the call of ``decode_step`` to its
  return, with no synchronize. No op of the step waits on the device, so
  this is the time the host takes to issue the step's launches (the launch
  queue never fills while the device is the faster of the two);
- *wall ms a step*: ``--steps`` steps between two ``torch.cuda.synchronize()``
  calls, divided by the steps, for each of ``--reps`` runs;
- *device busy ms a step*: ``torch.profiler`` over ``--prof-steps`` steps,
  the self time of every CUDA kernel, with the ``decode_attention`` kernels'
  part and the kernels a step. The idle share is 1 − busy / wall.

It also reports the host ms a step spent inside the ``decode_attention``
wrapper and the ops with the most host time a step in the profiled steps.
``--spin-ms 0,15`` cycles the timed runs through those values: in a run
with a value above 0, a spin kernel of that many ms (``torch.cuda._sleep``,
calibrated by CUDA events) is queued before each step (``--spin-at step``)
or after each ``decode_attention`` call (``--spin-at attn``), so the device
is kept busy while the host issues; the host and wall ms are reported for
each value. That tells whether the host issues a step at another speed
while the device is busy. One warm step runs under
``torch.cuda.set_sync_debug_mode("warn")``: the lines of the step that make
the host wait on the device are reported with their counts (``sync_sites``).

It imports only ``serving``, ``transformer``, ``configs`` and the kernel
wrapper's module, so the same file can time another checkout of the port:
run it by path with that checkout's ``src`` on ``PYTHONPATH``. Prints one
JSON line.

Usage (on a machine with an NVIDIA GPU):

    PYTHONPATH=src python -m repro_torch.launch.decode_profile \\
        --arch recurrentgemma-9b --full --batch 4 --prompt-len 2304
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import time
import warnings

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T


def _spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, by CUDA events."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def _sync_sites(fn) -> list[dict]:
    """Run ``fn()`` with CUDA sync debugging on; the source lines that
    synchronised the host with the device, with their counts."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return [{"site": k, "count": n} for k, n in sites.most_common()]


@torch.inference_mode()
def profile_decode(arch: str, batch: int = 4, prompt_len: int = 2304,
                   steps: int = 31, reps: int = 3, prof_steps: int = 5,
                   top_ops: int = 12, seed: int = 0, full: bool = False,
                   spin_ms: tuple[float, ...] = (0.0,),
                   spin_at: str = "step"):
    """The numbers the module docstring lists, as a dict (ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = get_config(arch) if full else get_reduced(arch)
    model = T.init_model(cfg, seed, dev, torch.bfloat16)
    cap = prompt_len + 3 + reps * len(spin_ms) * steps + prof_steps + 1
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    frontend = {}  # whisper's frames, llava's patches: as serve draws them
    if cfg.family == "encdec":
        frontend["frames"] = 0.1 * torch.randn(
            batch, cfg.encoder_seq, cfg.d_model, generator=gen, device=dev)
    if cfg.family == "vlm":
        frontend["patches"] = 0.1 * torch.randn(
            batch, cfg.patch_positions, cfg.d_model, generator=gen,
            device=dev)
    cache, h = SV.prefill(model, prompts, cap, dtype=torch.bfloat16,
                          kv_dtype=torch.bfloat16, **frontend)
    tok = SV.vocab_parallel_argmax((h[:, -1:] @ model.embed.head).float())

    wrapper = attn_ops.decode_attention
    in_wrapper = [0.0]
    attn_spin = [0]  # cycles queued after each decode_attention call

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = wrapper(*args, **kw)
        in_wrapper[0] += time.perf_counter() - t0
        if attn_spin[0]:
            torch.cuda._sleep(attn_spin[0])
        return out

    def step(tok):
        return SV.decode_step(model, cache, tok, cap, torch.bfloat16)[0]

    cycles_per_ms = _spin_cycles_per_ms() if any(spin_ms) else 0.0
    attn_ops.decode_attention = timed
    try:
        for _ in range(2):
            tok = step(tok)
        torch.cuda.synchronize()
        box = [tok]
        sync_sites = _sync_sites(lambda: box.__setitem__(0, step(box[0])))
        tok = box[0]
        torch.cuda.synchronize()
        in_wrapper[0] = 0.0
        host = {s: [] for s in spin_ms}
        walls = {s: [] for s in spin_ms}
        for r in range(reps * len(spin_ms)):
            spin = spin_ms[r % len(spin_ms)]
            cycles = int(spin * cycles_per_ms)
            attn_spin[0] = cycles if spin_at == "attn" else 0
            t_run = time.perf_counter()
            for _ in range(steps):
                if cycles and spin_at == "step":
                    torch.cuda._sleep(cycles)
                t0 = time.perf_counter()
                tok = step(tok)
                host[spin].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            walls[spin].append((time.perf_counter() - t_run) * 1e3 / steps)
        attn_spin[0] = 0
        wrapper_ms = in_wrapper[0] * 1e3 / (reps * len(spin_ms) * steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_steps):
                tok = step(tok)
            torch.cuda.synchronize()
    finally:
        attn_ops.decode_attention = wrapper
    busy_us = attn_us = kernels = 0
    cpu_ops = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if str(ev.device_type).endswith("CUDA"):
            if dev_us > 0:
                busy_us += dev_us
                kernels += ev.count
                if "decode_attention" in ev.key:
                    attn_us += dev_us
        elif ev.self_cpu_time_total > 0:
            cpu_ops.append((ev.self_cpu_time_total, ev.key, ev.count))
    cpu_ops.sort(reverse=True)
    wall = statistics.median(walls[spin_ms[0]])
    busy = busy_us / prof_steps / 1e3
    by_spin = [{"spin_ms": sp, "host_ms": statistics.median(host[sp]),
                "host_ms_min": min(host[sp]), "host_ms_max": max(host[sp]),
                "wall_ms": walls[sp]} for sp in spin_ms]
    return {
        "arch": arch, "full": full, "batch": batch, "prompt_len": prompt_len,
        "steps": steps, "reps": reps, **by_spin[0], "spin_at": spin_at,
        "by_spin": by_spin,
        "sync_sites": sync_sites,
        "wrapper_host_ms": wrapper_ms, "busy_ms": busy or None,
        "attn_busy_ms": attn_us / prof_steps / 1e3 if busy else None,
        "kernels_per_step": kernels / prof_steps if busy else None,
        "idle_share": 1 - busy / wall if busy else None,
        "top_host_ops": [
            {"op": k, "ms_per_step": us / prof_steps / 1e3,
             "calls_per_step": n / prof_steps}
            for us, k, n in cpu_ops[:top_ops]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--full", action="store_true",
                    help="published width (default: the reduced twin)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2304)
    ap.add_argument("--steps", type=int, default=31)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--prof-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spin-ms", default="0",
                    help="comma list: ms of device spin queued before each "
                         "step, cycled over the timed runs")
    ap.add_argument("--spin-at", choices=("step", "attn"), default="step")
    ap.add_argument("--label", default="", help="copied into the JSON line")
    args = ap.parse_args()
    res = profile_decode(args.arch, args.batch, args.prompt_len, args.steps,
                         args.reps, args.prof_steps, seed=args.seed,
                         full=args.full,
                         spin_ms=tuple(float(x) for x in
                                       args.spin_ms.split(",")),
                         spin_at=args.spin_at)
    print(json.dumps({"label": args.label, **res}), flush=True)


if __name__ == "__main__":
    main()
