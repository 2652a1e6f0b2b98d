"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1_000_000.0,
    opt_moments="int8",
    notes="123B dense; GQA kv=8; the largest dense cell in the pool.",
))
