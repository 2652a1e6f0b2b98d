"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name`` gives.

NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: 989 TFLOP/s dense
bf16 (1 979 with sparsity), 3.35 TB/s HBM3.  The rates assume the full
700 W power limit; every share the benchmark prints carries the card's
own limit beside it (``power_limit``).
"""
from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(card: str) -> dict:
    if card not in PEAKS:
        raise ValueError(f"no published peaks for {card!r}; the table has "
                         f"{sorted(PEAKS)}")
    return PEAKS[card]


def power_limit() -> str:
    """``power.limit`` of the first card as nvidia-smi reports it, or
    "unknown" where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() or "unknown"
