"""Serving driver: batched prefill + greedy autoregressive decode.

The port's counterpart of :mod:`repro.launch.serve`: draw a model from a
seed, prefill a batch of random prompts, then greedy-decode continuations
through the ring-cache / recurrent-state serving stack
(:mod:`repro_torch.models.serving`). ``full=True`` runs the published
configuration; otherwise its reduced twin. Runs on the card unless the
caller passes ``device="cpu"``.

Usage (on a machine with an NVIDIA GPU):

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --full --batch 4 --prompt-len 2304 --gen 32
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.inference_mode()
def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          seed: int = 0, full: bool = False, dtype=torch.bfloat16,
          device="cuda"):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens greedily (the first from the prefill's last hidden
    state, then ``gen - 1`` decode steps). Weights, activations and the KV
    cache are ``dtype``. Returns (generated ids (batch, gen) int64 on the
    host, {prefill_s, decode_s, tok_per_s}) with times from host clocks
    around ``torch.cuda.synchronize()``."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_reduced(arch)
    model = T.init_model(cfg, seed, dev, dtype)
    seq_cap = prompt_len + gen
    gen_tok = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_tok, device=dev)

    t0 = _clock(dev)
    cache, h = SV.prefill(model, prompts, seq_cap, dtype=dtype,
                          kv_dtype=dtype)
    logits = (h[:, -1:] @ model.embed.head.to(dtype)).float()
    tok = SV.vocab_parallel_argmax(logits)
    t_prefill = _clock(dev) - t0

    out = [tok]
    t0 = _clock(dev)
    for _ in range(gen - 1):
        tok, _, cache = SV.decode_step(model, cache, tok, seq_cap, dtype)
        out.append(tok)
    t_decode = _clock(dev) - t0
    generated = torch.cat(out, dim=1).cpu()
    return generated, {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--full", action="store_true",
                    help="published width (default: the reduced twin)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ids, stats = serve(args.arch, args.batch, args.prompt_len, args.gen,
                       args.seed, args.full, _DTYPES[args.dtype], args.device)
    print(f"generated shape {tuple(ids.shape)}")
    print(f"prefill {stats['prefill_s']:.3f}s decode {stats['decode_s']:.3f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    print("first sequences:", ids[:2, :10].tolist())


if __name__ == "__main__":
    main()
