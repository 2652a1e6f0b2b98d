"""qwen3-32b [dense] — qk_norm + GQA; hf:Qwen/Qwen3-32B family."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    notes="qk RMS-norm per head (qwen3); head_dim=128 so q-proj is "
          "n_heads*head_dim=8192 != d_model (as in the real model).",
))
