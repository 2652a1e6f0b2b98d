"""smollm-360m [dense] — llama-arch small; hf:HuggingFaceTB/SmolLM-360M."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, head_dim=64, rope_theta=10_000.0, tie_embeddings=True,
    notes="small llama-family model; also the end-to-end training example. "
          "15 heads is not divisible by tp=16: attention heads replicate "
          "over 'model' while FFN/vocab still shard (see models/common.py).",
))
