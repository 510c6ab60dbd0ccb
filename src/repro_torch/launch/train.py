"""Training entry point: a few AdamW steps of an LM on a synthetic token stream.

The port's counterpart of :mod:`repro.launch.train` (its CPU-scale mode):
draw a model from a seed, then run :func:`repro_torch.models.transformer.
make_train_step` on batches of a Markov-ish synthetic stream. ``full=True``
runs the published configuration (``n_layers`` cuts its depth); otherwise
its reduced twin. Float32 master weights and AdamW state; the forward and
backward compute in ``dtype``. Runs on the card unless the caller passes
``device="cpu"``.

Usage (on a machine with an NVIDIA GPU; 3 layers of recurrentgemma-9b at
full width peak at ~58 GB with their f32 weights, gradients, AdamW state and
activations at batch 2 × 2048, and 38 layers do not fit one 80 GB card):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-9b --full --n-layers 3 --batch 2 --seq 2049
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --dtype float32                      # the reduced twin, seconds
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import _MISSING, check_trainable

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def synthetic_batch(gen: torch.Generator, cfg, batch: int, seq: int):
    """``seq`` tokens per row, each either uniform or (with probability ½)
    a copy of the token 7 places back (a roll, as the reference's), drawn
    from ``gen`` on its device; returns {"tokens", "labels"}, each (batch,
    seq − 1) int64, the labels shifted by one."""
    dev = gen.device
    base = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev)
    shifted = torch.roll(base, 7, dims=1)
    use_copy = torch.rand((batch, seq), generator=gen, device=dev) < 0.5
    tokens = torch.where(use_copy, shifted, base)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def train_reduced(arch: str, steps: int = 100, batch: int = 8, seq: int = 129,
                  log_every: int = 10, peak_lr: float = 1e-3,
                  warmup_steps: int = 20, seed: int = 0, full: bool = False,
                  n_layers: int | None = None, dtype=torch.bfloat16,
                  device="cuda", ckpt_dir: str | None = None):
    """Train ``arch`` (its reduced twin, or the published width with
    ``full``; ``n_layers`` cuts the depth) for ``steps`` steps of ``batch``
    × (``seq`` − 1) tokens. Returns (model, history): one dict per step
    with loss, nll, grad_norm, lr and the step's seconds (host clock
    around ``torch.cuda.synchronize()``). Raises ``FloatingPointError`` if
    the loss stops being finite."""
    if ckpt_dir is not None:
        raise NotImplementedError(f"{arch}: {_MISSING['ckpt']}")
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_reduced(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    check_trainable(cfg, dev)
    model = T.init_model(cfg, seed, dev, torch.float32)
    model.requires_grad_(True)
    opt = T.init_opt(model)
    step_fn = T.make_train_step(cfg, dtype=dtype, peak_lr=peak_lr,
                                warmup_steps=warmup_steps)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    history = []
    t_start = _clock(dev)
    for i in range(steps):
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
    return model, history


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
                    help="not supported yet (raises)")
    args = ap.parse_args()
    _, history = train_reduced(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        peak_lr=args.lr, warmup_steps=args.warmup_steps, seed=args.seed,
        full=args.full, n_layers=args.n_layers, dtype=_DTYPES[args.dtype],
        device=args.device, ckpt_dir=args.ckpt_dir)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"(started {history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
