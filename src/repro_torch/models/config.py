"""Model configuration for the architecture zoo.

Framework-free copy of ``repro.models.config``.

A ``ModelConfig`` fully describes one architecture: the layer pattern (one
char per layer row: ``a`` = attention + dense SwiGLU FFN, ``e`` =
attention + MoE FFN, ``1`` = Mamba-1 block, ``2`` = Mamba-2 block), the
transformer dimensions, and the modality frontend.

Tensor-parallel padding: head counts and expert counts that do not divide
the model axis are padded with inert (zero-initialized, masked) units;
``padded_heads``/``padded_experts`` report the padded sizes for a given tp
so the roofline's useful-FLOPs ratio can account for the waste.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


def pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    # dense residual MLP alongside the MoE branch (Snowflake Arctic)
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    def padded_experts(self, tp: int) -> int:
        return pad_to(self.num_experts, tp)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64          # mamba2 only
    dt_rank: int = 0           # mamba1: ceil(d_model/16) when 0
    version: int = 1           # 1 = Mamba-1 (S6), 2 = Mamba-2 (SSD)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper) - same dims as decoder
    unless overridden.  ``source_len`` is the (stub) frontend's output
    sequence length (audio frames / vision patches)."""
    n_layers: int
    source_len: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: str             # one char per layer row, len == n_layers
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrids: the shared attention block (Zamba2) is one param set reused
    # at every 'a' position in the pattern
    shared_attention: bool = False
    frontend: str = "text"         # text | vision_stub | audio_stub
    frontend_tokens: int = 0       # patches / frames consumed by the stub
    frontend_dim: int = 0          # stub embedding dim (0 -> d_model)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 8192     # used by long-context decode
    source: str = ""               # citation for the config values

    def __post_init__(self):
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_pattern length "
                f"{len(self.layer_pattern)} != n_layers {self.n_layers}")

    @property
    def head_dim(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    def padded_heads(self, tp: int) -> int:
        return pad_to(self.n_heads, tp) if self.n_heads else 0

    def padded_kv_heads(self, tp: int) -> int:
        """KV heads are sharded when divisible, replicated otherwise."""
        if self.n_kv_heads == 0:
            return 0
        return self.n_kv_heads if self.n_kv_heads % tp == 0 else \
            self.n_kv_heads

    def kv_sharded(self, tp: int) -> bool:
        return self.n_kv_heads > 0 and self.n_kv_heads % tp == 0

    def padded_vocab(self, tp: int) -> int:
        return pad_to(self.vocab_size, tp)

    # ---- parameter / FLOP accounting (for the roofline) ------------------

    def param_count(self, tp: int = 1) -> int:
        """Total parameter count (with tp padding).  MoE counts all
        experts; ``active_param_count`` counts routed-active only."""
        return _count_params(self, tp, active_only=False)

    def active_param_count(self, tp: int = 1) -> int:
        return _count_params(self, tp, active_only=True)


def _attn_params(cfg: ModelConfig, tp: int) -> int:
    hq = cfg.padded_heads(tp)
    hkv = cfg.padded_kv_heads(tp)
    hd = cfg.head_dim
    return cfg.d_model * hq * hd + 2 * cfg.d_model * hkv * hd \
        + hq * hd * cfg.d_model


def _ffn_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff  # SwiGLU: gate, up, down


def _moe_params(cfg: ModelConfig, tp: int, active_only: bool) -> int:
    m = cfg.moe
    n_e = m.top_k if active_only else m.padded_experts(tp)
    p = n_e * 3 * cfg.d_model * m.expert_d_ff
    p += cfg.d_model * m.padded_experts(tp)  # router
    if m.dense_residual_d_ff:
        p += 3 * cfg.d_model * m.dense_residual_d_ff
    return p


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    if s.version == 1:
        dt_rank = s.dt_rank or math.ceil(cfg.d_model / 16)
        return (cfg.d_model * 2 * d_in            # in_proj (x, z)
                + d_in * s.d_conv                 # depthwise conv
                + d_in * (dt_rank + 2 * s.d_state)  # x_proj
                + dt_rank * d_in                  # dt_proj
                + d_in * s.d_state                # A_log
                + d_in                            # D
                + d_in * cfg.d_model)             # out_proj
    n_heads = d_in // s.headdim
    return (cfg.d_model * (2 * d_in + 2 * s.d_state + n_heads)  # in_proj
            + (d_in + 2 * s.d_state) * s.d_conv
            + n_heads * 2                        # A_log, D (per head)
            + d_in                               # norm
            + d_in * cfg.d_model)                # out_proj


def _count_params(cfg: ModelConfig, tp: int, active_only: bool) -> int:
    total = cfg.padded_vocab(tp) * cfg.d_model          # embedding
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab(tp) * cfg.d_model     # lm head
    shared_attn_counted = False
    for ch in cfg.layer_pattern:
        if ch == "a":
            if cfg.shared_attention:
                if not shared_attn_counted:
                    total += _attn_params(cfg, tp) + _ffn_params(cfg)
                    shared_attn_counted = True
            else:
                total += _attn_params(cfg, tp) + _ffn_params(cfg)
        elif ch == "e":
            total += _attn_params(cfg, tp) + _moe_params(cfg, tp,
                                                         active_only)
        elif ch in "12":
            total += _ssm_params(cfg)
        else:
            raise ValueError(f"unknown layer kind {ch!r}")
    if cfg.encoder:
        # encoder rows: attention + FFN per layer (whisper-style)
        total += cfg.encoder.n_layers * (_attn_params(cfg, tp)
                                         + _ffn_params(cfg))
        # decoder cross-attention per 'a' row
        total += cfg.layer_pattern.count("a") * _attn_params(cfg, tp)
    return total


# Standard decoder row patterns -------------------------------------------

def dense_pattern(n_layers: int) -> str:
    return "a" * n_layers


def ssm_pattern(n_layers: int, version: int) -> str:
    return ("1" if version == 1 else "2") * n_layers


def hybrid_pattern(n_layers: int, attn_every: int, offset: int = 5) -> str:
    """Mamba2 rows with shared attention rows interleaved (Zamba2)."""
    rows = []
    for i in range(n_layers):
        rows.append("a" if (i % attn_every) == offset else "2")
    return "".join(rows)
