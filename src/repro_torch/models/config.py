"""Architecture configuration for the LM families — the port's own copy.

A copy of :mod:`repro.models.config` (``MoEConfig``, ``ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``_expand_pattern``, ``layer_kinds``,
``reduced``): the port imports nothing
of the JAX package, not even its pure-Python dataclasses. One frozen dataclass
describes every architecture the reference supports, and the port builds
each of them and trains each on both devices (:func:`check_trainable`).

Parallelism modes (kept for parity with the reference's configs):
  * ``sp`` — sequence-parallel residual stream (attention-dominant archs:
    the dense, MoE, encoder-decoder and VLM families).
  * ``tp`` — replicated-seq residual stream with head/feature-sharded mixers
    (recurrence archs). On one device every collective is the identity, so
    both modes run the same math; they differ in their layers' weights
    (QKV biases, swiglu) and, in the reference, their sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN path in parallel


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    swa_window: int | None = None  # sliding-window attention (mixtral)
    moe: MoEConfig | None = None
    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rglru",
    # "rglru", "attn"); rwkv6 uses ("rwkv",); dense/moe archs use ("attn",)
    # implicitly.
    block_pattern: tuple[str, ...] = ("attn",)
    local_attn_window: int | None = None  # rgemma local attention
    rnn_width: int = 0  # RG-LRU recurrence width (0 → d_model)
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend sequence length (audio frames)
    # vlm (llava): number of patch-embedding positions (stub frontend)
    patch_positions: int = 0
    parallel_mode: Literal["sp", "tp"] = "sp"
    # True when the architecture has a sub-quadratic decode path.
    subquadratic: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded for TP divisibility (Megatron-style)."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A workload shape: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _expand_pattern(pattern: tuple[str, ...], n_layers: int) -> tuple[str, ...]:
    reps = (n_layers + len(pattern) - 1) // len(pattern)
    return (pattern * reps)[:n_layers]


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    return _expand_pattern(cfg.block_pattern, cfg.n_layers)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (the reference's rule)."""
    small = dict(
        n_layers=min(cfg.n_layers, len(cfg.block_pattern) * 2),
        d_model=128,
        n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        rnn_width=128 if cfg.rnn_width else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        patch_positions=min(cfg.patch_positions, 16) if cfg.patch_positions else 0,
        swa_window=64 if cfg.swa_window else None,
        local_attn_window=32 if cfg.local_attn_window else None,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4)
        )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for any block kind, norm, MLP or
    parallel mode the port cannot run; the port never runs a config as
    something else. Every family of the reference serves: dense, MoE,
    encoder-decoder, VLM (stub frontends), and the RG-LRU and RWKV6
    recurrences."""
    if cfg.parallel_mode not in ("sp", "tp"):
        raise NotImplementedError(f"{cfg.name}: parallel mode "
                                  f"{cfg.parallel_mode!r}")
    if cfg.norm not in ("rmsnorm", "layernorm") or cfg.mlp not in (
            "gelu", "swiglu"):
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm!r}, mlp "
                                  f"{cfg.mlp!r}")
    unknown = set(cfg.block_pattern) - {"attn", "rglru", "rwkv"}
    if unknown:
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(unknown)}")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: untied embeddings only")


def check_trainable(cfg: ModelConfig, device) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot train on
    ``device`` (a ``torch.device`` or its name). Every family the port runs
    trains on both devices: the SP-mode dense, MoE, encdec and VLM stacks
    and the TP-mode recurrences, whose kernels (``fused_ce``,
    ``rglru_scan``, ``rwkv6_scan``) each have a backward on the card and
    differentiate through their plain versions on the CPU. What
    :func:`check_supported` refuses stays refused."""
    check_supported(cfg)
