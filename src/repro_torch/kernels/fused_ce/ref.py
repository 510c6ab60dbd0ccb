"""Plain PyTorch cross-entropy parts: per-token logsumexp and target logit.

The counterpart of :func:`repro.kernels.fused_ce.ref.fused_ce_ref`, returning
the pair that ``csrc/fused_ce.cu`` (and the TPU kernel) returns instead of
their difference. The products are float32 products of the inputs' values,
as the kernels take them (a bfloat16 input is exact in float32). With
``round_logits`` each logit is then rounded to bfloat16 and back: the logits
of the reference's bf16 loss, whose ``x @ head`` is a bf16 dot. The CPU
path and the tests use it; on the card it is only the kernel's yardstick of
correctness.
"""

from __future__ import annotations

import torch


_CHUNK = 1024  # tokens whose (chunk, V) logits are live at once


def fused_ce_ref(x, w, labels, round_logits: bool = False):
    """x (T, D); w (D, V); labels (T,), T > 0. Returns (lse (T,), tgt (T,))
    float32: ``logsumexp(x·w)`` and ``(x·w)[label]`` per token (0 for a
    label outside [0, V), as the kernels give: a vocabulary block's
    labels of other blocks), the logits formed 1024 tokens at a time
    (rounded to bfloat16 first if ``round_logits``)."""
    wf = w.float()
    lse, tgt = [], []
    for t0 in range(0, x.shape[0], _CHUNK):
        logits = x[t0:t0 + _CHUNK].float() @ wf
        if round_logits:
            logits = logits.to(torch.bfloat16).float()
        lse.append(torch.logsumexp(logits, dim=-1))
        lab = labels[t0:t0 + _CHUNK].long()
        hit = (lab >= 0) & (lab < w.shape[1])
        got = torch.gather(logits, 1, lab.clamp(0, w.shape[1] - 1)[:, None])
        tgt.append(torch.where(hit, got[:, 0], 0.0))
    return torch.cat(lse), torch.cat(tgt)
