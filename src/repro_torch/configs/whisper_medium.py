"""whisper-medium [audio] — enc-dec; conv frontend stubbed; arXiv:2212.04356."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, enc_dec=True, n_enc_layers=24, enc_seq=1500,
    rope_theta=10_000.0,
    notes="transformer BACKBONE only: input_specs() provides precomputed "
          "frame embeddings (batch, 1500, d_model) in place of the conv "
          "frontend (stub per assignment).  Decoder self-attn KV cache + "
          "per-request cross-attn KV (computed once at encode).",
))
