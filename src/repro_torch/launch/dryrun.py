"""Dry run: count every (architecture x input-shape) cell's step on the
``meta`` device, its memory, and its roofline at the card's figures.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/

Per cell this writes ``<out>/<arch>__<shape>__h100.json``:
    memory      the step's argument, output and resident bytes and whether
                they fit the card (``fits_h100_80g``)
    roofline    compute / memory / collective terms in seconds at the
                H100's data-sheet peaks (``device.py``), and the counts
    top_hbm     the ops that move the most bytes

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on 256- and 512-chip meshes and reads XLA's memory and
cost analyses.  Here one card holds the whole step: the model is built on
``meta`` from ``abstract_params()`` and its step is counted op by op
(``roofline.count``), so it needs no card and no compiler.  The step is
the cell's: ``prefill``, ``decode_step`` against a cache of the shape's
length (``init_cache``), or the train step (``trainer.make_train_step``
with ``pick_microbatches``).  No sharded bytes, no collectives (0 on one
card), no XLA fallbacks and no compile time.  The fit counts the step's
arguments and outputs, not its activations: eager PyTorch has no
``memory_analysis``.  In place of the reference's ``panel_hints`` the two
attention kernels count at their own boundary (``roofline.count``); the
mamba and mLSTM (chunk, chunk) decay masks, which the reference's hints
also discount, are plain torch in the port and count in full.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import base as C
from ..models import build, param_stats
from ..models.model import Model
from ..optim import OptConfig, Optimizer
from ..train.trainer import make_train_step, pick_microbatches
from . import roofline as R
from .device import SPECS, DeviceSpec, device_spec


def model_flops(stats: Dict[str, float], kind: str, batch: int,
                seq_len: int) -> float:
    """6 N D for a train step, 2 N D for prefill and decode (the JAX
    package's MODEL_FLOPS): N is ``param_stats``' active non-embedding
    parameters, D the step's new tokens (one a row in decode)."""
    D = batch * (seq_len if kind in ("train", "prefill") else 1)
    return (6 if kind == "train" else 2) * stats["active_non_embed"] * D


def _top(by_shape: Dict[str, float], n: int = 8) -> Dict[str, float]:
    return dict(sorted(by_shape.items(), key=lambda kv: -kv[1])[:n])


def _bytes(tensors) -> int:
    return sum(R.tensor_bytes(t) for t in tensors)


def abstract_step(model: Model, kind: str, batch: int, seq_len: int, *,
                  max_len: int = 0, n_micro: Optional[int] = None):
    """(step, args, meta) of one step of ``model`` (built on ``meta``)
    with its ``abstract_params()``: ``kind`` 'prefill' over (batch,
    seq_len) tokens into a cache of ``max_len``; 'decode' one token
    against a cache of ``seq_len`` positions (``max_len``: that cache's
    size) holding ``seq_len`` - 1 tokens; 'train' one optimizer step over
    a (batch, seq_len) batch in ``n_micro`` microbatches (default
    ``pick_microbatches``)."""
    cfg, dev = model.cfg, model.device
    tokens = torch.zeros(batch, seq_len, dtype=torch.int64, device=dev)
    frames = (torch.zeros(batch, cfg.enc_seq, cfg.d_model, dtype=model.dtype,
                          device=dev) if cfg.enc_dec else None)
    params = model.abstract_params()
    if kind == "train":
        opt = Optimizer(OptConfig(moments=cfg.opt_moments))
        n_micro = n_micro or pick_microbatches(model, batch, seq_len)
        data = {"tokens": tokens, "labels": tokens}
        if frames is not None:
            data["frames"] = frames
        state = {"params": params, "opt": opt.init(params)}
        return (make_train_step(model, opt, n_micro=n_micro), (state, data),
                {"step": "train_step", "n_micro": n_micro})
    if kind == "prefill":
        def prefill(params, tokens, frames):
            return model.prefill(params, tokens, frames=frames,
                                 max_len=max_len)
        return prefill, (params, tokens, frames), {"step": "prefill"}
    cache = model.init_cache(batch, max(max_len, seq_len),
                             prompt_len=seq_len - 1)
    return (model.decode_step, (params, cache, tokens[:, -1:]),
            {"step": "serve_step"})


def count_step(cfg: C.ArchConfig, kind: str, batch: int, seq_len: int, *,
               max_len: int = 0, n_micro: Optional[int] = None,
               spec: Optional[DeviceSpec] = None) -> Dict[str, Any]:
    """The counted costs, memory and roofline of one step of ``cfg``
    (``abstract_step``) on ``meta``, at ``spec``'s peaks (default: the
    card's when one is present, else the H100 SXM5's data sheet)."""
    if spec is None:
        spec = (device_spec() if torch.cuda.is_available()
                else SPECS["H100-SXM5-80GB"])
    model = build(cfg, device="meta")
    step, args, meta = abstract_step(model, kind, batch, seq_len,
                                     max_len=max_len, n_micro=n_micro)
    t0 = time.perf_counter()
    out: list = []
    with torch.no_grad():
        costs = R.count(lambda *a: out.append(step(*a)), *args)
    count_s = time.perf_counter() - t0
    ins = R.tensors_of(args)
    outs = R.tensors_of(out)
    seen = {id(t) for t in ins}
    alias = _bytes(t for t in outs if id(t) in seen)
    params = args[0]["params"] if kind == "train" else args[0]
    param_bytes = _bytes(R.tensors_of(params))
    arg_bytes, out_bytes = _bytes(ins), _bytes(outs)
    resident = arg_bytes + out_bytes - alias
    stats = param_stats(model)
    mflops = model_flops(stats, kind, batch, seq_len)
    return {
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "resident_bytes": resident,
            "param_floor_bytes": param_bytes,
            "fits_h100_80g": bool(resident <= spec.hbm_bytes),
        },
        "roofline": R.spec_roofline(costs, spec),
        "collectives": dict(costs.coll_by_kind),
        "collective_counts": dict(costs.n_collectives),
        "top_collectives": _top(costs.coll_by_shape),
        "top_hbm": _top(costs.hbm_by_shape),
        "model_flops": mflops,
        "useful_flops_ratio": mflops / max(costs.flops, 1.0),
        "params": stats,
        "n_chips": 1,
        "device": spec.name,
        "count_s": count_s,
        "costs": costs,
        **meta,
    }


def run_cell(arch: str, shape_name: str, *,
             spec: Optional[DeviceSpec] = None) -> Dict[str, Any]:
    """One cell of ``configs.base.cells()``: its step counted on meta."""
    cfg = C.get(arch)
    shape = {s.name: s for s in C.ALL_SHAPES}[shape_name]
    out = count_step(cfg, shape.kind, shape.global_batch, shape.seq_len,
                     spec=spec)
    out.pop("costs")
    out.update({"arch": arch, "shape": shape_name})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(cfg.arch_id, shape.name) for cfg, shape in C.cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        tag = f"{arch}__{shape}__h100"
        try:
            res = run_cell(arch, shape)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1, default=float)
            r, m = res["roofline"], res["memory"]
            print(f"OK   {tag:48s} count={res['count_s']:6.1f}s "
                  f"resident={m['resident_bytes'] / 1e9:9.2f}GB "
                  f"fits={str(m['fits_h100_80g']):5s} "
                  f"bottleneck={r['bottleneck']:8s} "
                  f"t=({r['t_compute']:.2e},{r['t_memory']:.2e},"
                  f"{r['t_collective']:.2e})s", flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)
            if not args.quiet:
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print(f"\nall {len(cells)} cells passed")


if __name__ == "__main__":
    main()
