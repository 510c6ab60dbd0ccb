"""Training entry point: a few AdamW steps of an LM on a synthetic token stream.

The port's counterpart of :mod:`repro.launch.train` (its CPU-scale mode):
draw a model from a seed, then run :func:`repro_torch.models.transformer.
make_train_step` on batches of a Markov-ish synthetic stream. ``full=True``
runs the published configuration (``n_layers`` cuts its depth); otherwise
its reduced twin. Every family trains: the TP-mode recurrences and the
SP-mode dense, MoE, encoder-decoder and VLM stacks (the last two on stub
frames or patches drawn with the batch). Float32 master weights; AdamW
moments in the config's ``opt_dtype`` (bfloat16 for qwen1.5-110b and
arctic-480b); the forward and backward compute in ``dtype``. ``remat``
checkpoints each layer group's activations, as the reference's mesh-mode
step does (:func:`repro_torch.models.transformer.forward_hidden`). Runs on
the card unless the caller passes ``device="cpu"``.

With ``ckpt_dir`` the training state — the named parameters, the AdamW
state and the batch generator's state — is saved every ``ckpt_every``
steps through :class:`repro_torch.checkpoint.Checkpointer`, and a run
starts from the newest intact step there. The generator's state is part of
the checkpoint, so a resumed run draws the batches the contiguous run
draws: losses, parameters and optimizer state are bitwise the contiguous
run's.

Usage (on a machine with an NVIDIA GPU, at batch 2 × 2048). The training
state is 16 bytes a parameter (f32 weights, gradients, m and v; 12 with
bf16 moments) before activations: 3 layers of recurrentgemma-9b peak at
~58 GB, and 38 layers do not fit one 80 GB card; llama3.2-3b whole is
57.7 GB of state and fits only with ``--remat`` (each of its 28 layers
keeps ~2 GB of attention and MLP activations without it); 2 layers of
mixtral-8x7b are 50.6 GB, 1 layer of qwen1.5-110b 46.2 GB (bf16 moments),
12 layers of llava-next-mistral-7b 46.1 GB; whisper-tiny is small;
one arctic-480b layer is 163 GB and waits for expert parallelism:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-9b --full --n-layers 3 --batch 2 --seq 2049
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-3b --full --remat --batch 2 --seq 2049 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --dtype float32                      # the reduced twin, seconds
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --dtype float32 --steps 40 --ckpt-dir ckpt --ckpt-every 10
                                             # again with --steps 80: resumes
                                             # at step 40
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import check_trainable

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def synthetic_batch(gen: torch.Generator, cfg, batch: int, seq: int):
    """``seq`` tokens per row, each either uniform or (with probability ½)
    a copy of the token 7 places back (a roll, as the reference's), drawn
    from ``gen`` on its device; returns {"tokens", "labels"}, each (batch,
    seq − 1) int64, the labels shifted by one. The encoder-decoder family
    also gets "frames" (batch, encoder_seq, d), the VLM "patches" (batch,
    patch_positions, d), each 0.1·N(0, 1) float32 from ``gen`` after the
    tokens, as the reference draws its stub frontends' inputs."""
    dev = gen.device
    base = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev)
    shifted = torch.roll(base, 7, dims=1)
    use_copy = torch.rand((batch, seq), generator=gen, device=dev) < 0.5
    tokens = torch.where(use_copy, shifted, base)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    rows = {"encdec": ("frames", cfg.encoder_seq),
            "vlm": ("patches", cfg.patch_positions)}.get(cfg.family)
    if rows is not None:
        out[rows[0]] = 0.1 * torch.randn(batch, rows[1], cfg.d_model,
                                         generator=gen, device=dev)
    return out


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def train_reduced(arch: str, steps: int = 100, batch: int = 8, seq: int = 129,
                  log_every: int = 10, peak_lr: float = 1e-3,
                  warmup_steps: int = 20, seed: int = 0, full: bool = False,
                  n_layers: int | None = None, dtype=torch.bfloat16,
                  device="cuda", ckpt_dir: str | None = None,
                  ckpt_every: int = 50, remat: bool = False):
    """Train ``arch`` (its reduced twin, or the published width with
    ``full``; ``n_layers`` cuts the depth) for ``steps`` steps of ``batch``
    × (``seq`` − 1) tokens. Returns (model, history): one dict per step run
    here with loss, nll, lb_loss, drop_frac, grad_norm, lr and the step's
    seconds (host clock around ``torch.cuda.synchronize()``). ``remat``:
    activation checkpointing (the same numbers, less memory). Raises ``FloatingPointError`` if
    the loss stops being finite. ``ckpt_dir``: resume from its newest
    intact step (raises when every saved step is corrupt), and save there
    after every ``ckpt_every``-th step (asynchronously; joined before
    returning)."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_reduced(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    check_trainable(cfg, dev)
    model = T.init_model(cfg, seed, dev, torch.float32)
    model.requires_grad_(True)
    opt = T.init_opt(model)
    step_fn = T.make_train_step(cfg, dtype=dtype, peak_lr=peak_lr,
                                warmup_steps=warmup_steps, remat=remat)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    ck = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
    start = 0
    if ck is not None and ck.all_steps():
        state, manifest = ck.restore(_train_state(model, opt, gen))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state["params"][name])
        opt = state["opt"]
        gen.set_state(state["gen"])
        start = manifest["step"]
        print(f"resumed from step {start}", flush=True)
    history = []
    t_start = _clock(dev)
    for i in range(start, steps):
        b = synthetic_batch(gen, cfg, batch, seq)
        t0 = _clock(dev)
        metrics = step_fn(model, opt, b)
        loss = float(metrics["loss"])
        t1 = _clock(dev)
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(step=i, seconds=t1 - t0)
        history.append(rec)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {i}")
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {loss:7.4f} "
                  f"gnorm {rec['grad_norm']:7.3f} lr {rec['lr']:.2e} "
                  f"({t1 - t_start:.1f}s)", flush=True)
        if ck is not None and (i + 1) % ckpt_every == 0:
            ck.save(i + 1, _train_state(model, opt, gen))
    if ck is not None:
        ck.wait()
    return model, history


def _train_state(model, opt, gen) -> dict:
    """The tree a training checkpoint holds: ``{"params": named parameters,
    "opt": AdamWState, "gen": the batch generator's state (a CPU uint8
    tensor)}``."""
    return {"params": dict(model.named_parameters()), "opt": opt,
            "gen": gen.get_state()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="published width (default: the reduced twin)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest "
                         "intact step, save every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer group's activations")
    args = ap.parse_args()
    _, history = train_reduced(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        peak_lr=args.lr, warmup_steps=args.warmup_steps, seed=args.seed,
        full=args.full, n_layers=args.n_layers, dtype=_DTYPES[args.dtype],
        device=args.device, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, remat=args.remat)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"(started {history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
