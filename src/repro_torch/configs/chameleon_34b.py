"""chameleon-34b [vlm] — early-fusion, VQ image tokens; arXiv:2405.09818."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, qk_norm=True, rope_theta=10_000.0,
    notes="early-fusion VLM backbone = dense decoder-only LM; VQ image "
          "tokens are ordinary vocab ids (frontend stub: input_specs() "
          "yields fused token streams).  Chameleon uses qk-norm for "
          "training stability (per the paper).",
))
