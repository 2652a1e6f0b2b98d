"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8."""
from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    opt_moments="int8",
    notes="~1T total / ~32B active.  Expert weights are EP-sharded over "
          "'model' (384/16=24 experts per shard); optimizer moments int8 "
          "(8-bit Adam) — fp32 moments for 1T params cannot fit one pod.",
))
