#!/usr/bin/env python3
"""Train smollm-360m at full width and depth on the card and print its
loss curve, for comparing optimizer settings.

    python3 tools/train_curve.py [--steps 30] [--lr 3e-3] [--warmup 5]
        [--total 60] [--wd 0.1] [--dtype bfloat16] [--moments fp32]
        [--batch 8] [--seq 1024] [--data-vocab V] [--seed 0]

The run is chip_smoke.py's ``[train]`` run (``Trainer`` over
``SyntheticLM``, AdamW, remat per layer, one microbatch) with the given
settings; ``--data-vocab`` draws the token stream over the first V ids
(default: the model's whole vocabulary).  It prints one line: the settings, every step's loss, the mean
of the first and the last 5, and the median ms per step, beside the card's
name.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--total", type=int, default=60)
    ap.add_argument("--wd", type=float, default=0.1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--moments", default="fp32")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--data-vocab", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_curve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = dataclasses.replace(get("smollm-360m"), dtype=args.dtype)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(build(cfg, device="cuda"),
                     OptConfig(lr=args.lr, warmup_steps=args.warmup,
                               total_steps=args.total, weight_decay=args.wd,
                               moments=args.moments),
                     TrainConfig(ckpt_every=10 ** 9, ckpt_dir=tmp),
                     SyntheticLM(DataConfig(vocab=args.data_vocab or cfg.vocab,
                                            seq_len=args.seq,
                                            global_batch=args.batch,
                                            seed=args.seed)))
        tr.init_state(args.seed)
        losses = tr.run(args.steps)
    med = float(np.median([h["dt"] for h in tr.history]))
    print(f"[curve] {torch.cuda.get_device_name(0)}: smollm-360m {args.dtype}"
          f" lr {args.lr} warmup {args.warmup} total {args.total} wd "
          f"{args.wd} moments {args.moments} batch {args.batch} x seq "
          f"{args.seq} data vocab {args.data_vocab or cfg.vocab}: first 5 {np.mean(losses[:5]):.4f}, last 5 "
          f"{np.mean(losses[-5:]):.4f}, median {1e3 * med:.1f} ms a step; "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
