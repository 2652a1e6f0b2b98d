"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2."""
from .base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128, sub_quadratic=True,
    attn_every=8, attn_phase=4,  # 1 attention : 7 mamba, attn at i%8==4
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, moe_every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    opt_moments="int8",
    notes="Jamba-1.5-Large: 72 layers, attention on every 8th layer "
          "(i%8==4), MoE FFN on every 2nd layer.  Runs long_500k: the 9 "
          "attention layers hold a 524288-token paged KV cache; the 63 "
          "mamba layers carry O(1) state.",
))
