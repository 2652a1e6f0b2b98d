"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN."""
from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864),
    opt_moments="int8",
    notes="dense-MoE hybrid: a parallel always-on dense FFN (d_ff=4864) "
          "residual alongside the 128e top-2 MoE branch (Snowflake Arctic).",
))
