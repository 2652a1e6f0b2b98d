"""Sharded checkpointing: one ``.npy`` file (or ``shards`` of them) per
leaf + a JSON manifest, in the JAX package's format.

* **Sharded write**: every leaf is saved independently (chunked by leading
  axis into ``shards`` files when it has at least ``shards`` rows and over
  1 MiB); a thread pool writes them.
* **Atomic commit**: writes go to ``step_XXXXXXXX.tmp/``; the manifest
  (leaf names, shapes, logical dtypes, shard files and their CRC32s, step,
  ``extra``) is written last and the directory is renamed.  A crash
  mid-save leaves the previous checkpoint intact; ``latest()`` only ever
  sees committed directories.
* **Async save**: ``CheckpointManager.save_async`` copies the tensors to
  the host (blocking only for that copy) and writes on a background
  thread; at most one write is pending, and only the newest ``keep``
  checkpoints are kept.
* **Integrity**: each file's CRC32 is verified on load.

The format is the reference's byte for byte: leaves are named by their
path as JAX's ``tree_flatten_with_path`` spells it (dict keys sorted, list
indices, a ``Moment``'s fields as ``.value`` / ``.scale``, ``/`` between
them), bfloat16 is stored as its uint16 bits with ``"bfloat16"`` as the
logical dtype, and the manifest has the same keys in the same order.  So
each package loads the other's checkpoints.  ``load_checkpoint`` takes the
target ``device`` where the reference takes a mesh and partition specs.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.heap import resolve_device

MANIFEST = "manifest.json"


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) in the JAX package's flattening order and spelling."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], prefix + (str(k),))]
    fields = getattr(tree, "_fields", None)
    if isinstance(tree, tuple) and fields is not None:   # a NamedTuple
        return [x for f in fields
                for x in _leaf_paths(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaf_paths(t, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values`` (an iterator)."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], values) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None):
        return type(tree)(*(_unflatten(t, values) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, values) for t in tree)
    if tree is None:
        return None
    return next(values)


def _host(x) -> Tuple[np.ndarray, str]:
    """A tensor (or array) as a host numpy array and its logical dtype;
    bfloat16 as its uint16 bits (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: Dict = None,
                    shards: int = 4, workers: int = 8) -> str:
    """Synchronous sharded save with atomic commit.  Returns final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [(name, *_host(x)) for name, x in _leaf_paths(tree)]
    manifest: Dict[str, Any] = {"step": step, "extra": extra or {},
                                "leaves": {}}

    def write_leaf(item):
        name, arr, logical_dtype = item
        fname = name.replace("/", "__")
        entries = []
        if arr.ndim >= 1 and arr.shape[0] >= shards and arr.nbytes > 1 << 20:
            for i, ch in enumerate(np.array_split(arr, shards, axis=0)):
                f = f"{fname}.shard{i}.npy"
                np.save(os.path.join(tmp, f), ch)
                entries.append({"file": f, "crc": _crc(ch),
                                "rows": int(ch.shape[0])})
        else:
            f = f"{fname}.npy"
            np.save(os.path.join(tmp, f), arr)
            entries.append({"file": f, "crc": _crc(arr),
                            "rows": int(arr.shape[0]) if arr.ndim else -1})
        return name, {"shape": list(arr.shape), "dtype": logical_dtype,
                      "shards": entries}

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for name, meta in ex.map(write_leaf, leaves):
            manifest["leaves"][name] = meta

    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    """A loaded array as a tensor of ``like``'s dtype on ``device``."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


def load_checkpoint(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                    device=None, verify: bool = True):
    """Load (latest or specific step) onto ``device`` (``None``: the CUDA
    card).  ``tree_like``: a tree of tensors with the target structure and
    dtypes (``meta`` tensors will do).  Returns (tree, step, extra)."""
    dev = resolve_device(device)
    path = (os.path.join(ckpt_dir, f"step_{step:08d}") if step is not None
            else latest(ckpt_dir))
    assert path is not None, f"no checkpoint in {ckpt_dir}"
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    named = _leaf_paths(tree_like)

    def read_leaf(item):
        name, like = item
        meta = manifest["leaves"][name]
        parts = []
        for e in meta["shards"]:
            arr = np.load(os.path.join(path, e["file"]))
            if verify and _crc(arr) != e["crc"]:
                raise IOError(f"checksum mismatch in {e['file']}")
            parts.append(arr)
        full = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        assert list(full.shape) == meta["shape"], (name, full.shape)
        return _tensor(full, like, dev)

    with ThreadPoolExecutor(max_workers=8) as ex:
        arrays = list(ex.map(read_leaf, named))
    return (_unflatten(tree_like, iter(arrays)), manifest["step"],
            manifest.get("extra", {}))


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp")
                   and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _snapshot(tree):
    """``tree`` with a host copy of every tensor, taken before
    ``save_async`` returns, so later updates cannot reach it."""
    return _unflatten(tree, (
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
        for _, x in _leaf_paths(tree)))


class CheckpointManager:
    """Async saves + retention.  ``save_async`` returns right after the
    device-to-host copy; the write happens on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def save_async(self, step: int, tree, extra: Dict = None):
        self.wait()
        host_tree = _snapshot(tree)

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra)
            self._gc()

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()
        self.saved_steps.append(step)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)

    def latest(self) -> Optional[str]:
        return latest(self.ckpt_dir)
