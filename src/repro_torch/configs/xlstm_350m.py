"""xlstm-350m [ssm] — sLSTM + mLSTM blocks; arXiv:2405.04517."""
from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    arch_id="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=0, sub_quadratic=True,
    ssm=SSMConfig(slstm_every=4, chunk=256),
    notes="xLSTM[7:1]-style: every 4th block sLSTM (scalar memory, strictly "
          "sequential lax.scan), rest mLSTM (matrix memory, chunkwise-"
          "parallel).  No FFN (d_ff=0): blocks carry internal up/down "
          "projections.  Runs long_500k (recurrent state is O(1) in seq).",
))
