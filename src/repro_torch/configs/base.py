"""Architecture configuration: frozen ``ArchConfig`` dataclasses, a
registry, and ``reduced`` for CPU-sized twins.

Every input shape is a ``ShapeSpec``; an (arch, shape) pair is a dry-run
*cell* (``cells``, counted by ``launch/dryrun.py``).  ``long_500k`` is
taken only by the sub-quadratic configs; ``decode_*`` / ``long_*`` run
one decode step against a cache of ``seq_len``.

Counterpart of the JAX package's ``configs/base.py`` (same fields, same
parameter counts, same shapes and cells, same ``reduced`` rules).

``n_params`` is the reference's formula, kept as it is.  For the mamba,
xlstm and encoder-decoder families it does not count the leaves of the
models' parameter trees (``models.registry.param_stats`` does).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual_d_ff: int = 0   # arctic: parallel always-on dense FFN
    moe_every: int = 1             # jamba: MoE FFN on every k-th layer


@dataclass(frozen=True)
class SSMConfig:
    # mamba (S6)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # xlstm
    slstm_every: int = 0           # >0: every k-th layer is sLSTM (rest mLSTM)
    chunk: int = 256               # chunkwise-parallel scan block


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1            # hybrid: layer i is attention iff
                                   # (i % attn_every) == attn_phase, else mamba
    attn_phase: int = 0
    enc_dec: bool = False          # whisper: encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 1500            # whisper frame count after conv stub
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # distribution / memory knobs (overridable per run)
    remat: str = "block"           # 'none' | 'block' (remat each scanned layer)
    opt_moments: str = "fp32"      # 'fp32' | 'int8' (8-bit Adam for >100B)
    attn_chunk_q: int = 1024       # online-softmax query block (train/prefill)
    attn_chunk_kv: int = 2048      # kv block for decode length-sharding
    scan_layers: bool = True
    sub_quadratic: bool = False    # may lower long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Total parameter count (the reference's formula)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: only top_k experts)."""
        return _count_params(self, active_only=True)

    def shapes(self) -> List[ShapeSpec]:
        """The shapes this config is counted at: train, prefill and decode,
        and ``long_500k`` if it is sub-quadratic."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return out

    def skipped_shapes(self) -> List[Tuple[ShapeSpec, str]]:
        out = []
        if not self.sub_quadratic:
            out.append((LONG_500K, "full attention is quadratic at 524288; "
                        "shape reserved for ssm/hybrid archs"))
        return out


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.hd
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    qknorm = 2 * hd if cfg.qk_norm else 0
    return q + kv + o + qknorm


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # gate, up, down (SwiGLU)


def _mamba_params(cfg: ArchConfig) -> int:
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    return (cfg.d_model * 2 * d_in          # in_proj (x, z)
            + d_in * s.d_conv               # conv
            + d_in * (s.d_state * 2 + 1)    # B, C, dt per-channel proj basis
            + d_in * s.d_state              # A
            + d_in                          # D
            + d_in * cfg.d_model)           # out_proj


def _xlstm_params(cfg: ArchConfig, layer: int) -> int:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    slstm = s.slstm_every and ((layer + 1) % s.slstm_every == 0)
    if slstm:
        # 4 gates (i,f,z,o) input + recurrent, + up/down proj (factor 4/3)
        dp = int(4 * d / 3)
        return 4 * d * d + 4 * d * d + 2 * d * dp
    # mLSTM: qkv + i,f gates + out, inner dim 2*d
    di = 2 * d
    return d * 3 * di + 2 * d + di * d + 2 * d * di  # qkv, gates, out, up/down


def _layer_params(cfg: ArchConfig, i: int, active_only: bool) -> int:
    d = cfg.d_model
    norms = 2 * d
    if cfg.family == "ssm":
        return _xlstm_params(cfg, i) + norms
    is_attn = (i % cfg.attn_every) == cfg.attn_phase if cfg.attn_every > 1 else True
    mix = _attn_params(cfg) if is_attn else _mamba_params(cfg)
    if cfg.moe is not None and (i % cfg.moe.moe_every) == (cfg.moe.moe_every - 1):
        m = cfg.moe
        n_e = m.top_k if active_only else m.n_experts
        ffn = n_e * _ffn_params(d, m.d_ff_expert) + d * m.n_experts  # + router
        ffn += _ffn_params(d, m.dense_residual_d_ff) if m.dense_residual_d_ff else 0
    elif cfg.d_ff > 0:
        ffn = _ffn_params(d, cfg.d_ff)
    else:
        ffn = 0
    return mix + ffn + norms


def _count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model  # lm head
    total += cfg.d_model  # final norm
    for i in range(cfg.n_layers):
        total += _layer_params(cfg, i, active_only)
    if cfg.enc_dec:
        for i in range(cfg.n_enc_layers):
            total += _layer_params(cfg, i, active_only)
            total += _attn_params(cfg) + cfg.d_model  # decoder cross-attn+norm
    return total


# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get(arch_id: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def all_archs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (arctic_480b, chameleon_34b, jamba_1_5_large_398b,  # noqa
                   kimi_k2_1t_a32b, llama3_8b, mistral_large_123b,
                   qwen3_32b, smollm_360m, whisper_medium, xlstm_350m)


def cells() -> List[Tuple[ArchConfig, ShapeSpec]]:
    """Every (arch, shape) dry-run cell: 32 over the ten configs."""
    return [(get(a), s) for a in all_archs() for s in get(a).shapes()]


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128, d_ff_scale: int = 32) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads * n_heads // max(1, cfg.n_heads)))
    while n_heads % n_kv:
        n_kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4,
                                  top_k=min(2, cfg.moe.top_k),
                                  d_ff_expert=d_ff_scale,
                                  dense_residual_d_ff=(d_ff_scale if
                                  cfg.moe.dense_residual_d_ff else 0))
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=8, chunk=16)
    # keep at least one full superblock period
    period = max(cfg.attn_every,
                 (cfg.ssm.slstm_every if cfg.ssm else 0) or 1, 1)
    n_layers = max(n_layers, period)
    n_layers = ((n_layers + period - 1) // period) * period
    return dataclasses.replace(
        cfg, arch_id=cfg.arch_id + "-reduced", n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=(d_ff_scale * 2 if cfg.d_ff else 0), vocab=vocab, head_dim=16,
        moe=moe, ssm=ssm, n_enc_layers=(n_layers if cfg.enc_dec else 0),
        enc_seq=24, dtype="float32", attn_chunk_q=16, attn_chunk_kv=32,
        opt_moments="fp32")
