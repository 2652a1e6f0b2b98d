"""A cell small enough for the CPU: two layers at width 64 in float32,
the port's plain kernels, four closed-loop clients over two slots."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import harness, spec  # noqa: E402

PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def cell(limit: float = 1e-3, dtype: str = "float32", **mix) -> spec.Cell:
    bench = spec.benchmark()
    cfg = {"hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
           "rms_norm_eps": 1e-6, "rope_theta": 1e6, "qk_norm": True,
           "tie_word_embeddings": False, "torch_dtype": dtype,
           "pool": {"n_pages": 1024, "n_buckets": 256,
                    "slots_per_bucket": 8, "replicas": 3,
                    "chunk_pages": 64, "n_shards": 4}}
    traffic = {"loop": "closed", "clients": 4, "max_batch": 2,
               "max_len": 256, "shared_prefix_tokens": 128,
               "own_tokens": 64, "new_tokens": 4, "profile_waves": 1,
               "check_requests": 3, **mix}
    return spec.Cell("tiny.shared-prefix", "tiny", cfg, traffic,
                     {"logit_gap": limit}, bench["end_to_end"],
                     bench["per_layer"])


def run(c: spec.Cell, seed: int = 2 ** 31 + 7, seconds: float = 2.0,
        traced: bool = False, faults=None, control: bool = False) -> dict:
    """One run of ``c`` on the CPU, on one thread as ``run.py`` runs (the
    test workers share the cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.execute(c, seed, seconds, traced, "cpu",
                               time.perf_counter(), "cpu", PEAKS,
                               faults=faults, control=control)
    finally:
        torch.set_num_threads(threads)
