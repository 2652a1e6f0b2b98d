"""Weights drawn on the device from the run's seed, laid out by name from
a configuration file's widths.

The tree has the serving model's layout (``embed`` (Vp, D),
``final_norm``, ``lm_head`` (D, Vp), one ``layers`` entry whose leaves
are stacked over the layers), so the harness hands it to the program
as its parameters and the same tensors to the plain reference.  Each
leaf is one call of the card's ``torch.Generator`` in the type the
model is served in: normal with std 1/sqrt(fan_in) for a matrix, 0.02
for the embedding, uniform in [0.5, 1.5) for a norm's gain.  The rows
(columns) of the embedding (head) past the published vocabulary, which
the program pads to a multiple of 256, are zero.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from .count import Widths

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def seed64(seed: int) -> int:
    """Any whole number as a seed a generator takes (0 <= s < 2**63)."""
    return int(seed) % (2 ** 63)


def pad_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def leaves(w: Widths) -> Iterator[Tuple[Tuple[str, ...], tuple, str, float]]:
    """(path, shape, init, std) of every leaf, in the order drawn."""
    L, D, H, KV, hd, F = w.layers, w.d, w.heads, w.kv, w.hd, w.ff
    vp = pad_vocab(w.vocab)
    yield ("embed",), (vp, D), "embed", 0.02
    yield ("final_norm",), (D,), "gain", 0.0
    yield ("lm_head",), (D, vp), "head", 1 / math.sqrt(D)
    yield ("layers", "ln1"), (L, D), "gain", 0.0
    yield ("layers", "ln2"), (L, D), "gain", 0.0
    yield ("layers", "attn", "wq"), (L, D, H, hd), "normal", 1 / math.sqrt(D)
    yield ("layers", "attn", "wk"), (L, D, KV, hd), "normal", 1 / math.sqrt(D)
    yield ("layers", "attn", "wv"), (L, D, KV, hd), "normal", 1 / math.sqrt(D)
    yield (("layers", "attn", "wo"), (L, H, hd, D), "normal",
           1 / math.sqrt(H * hd))
    if w.qk_norm:
        yield ("layers", "attn", "q_norm"), (L, hd), "gain", 0.0
        yield ("layers", "attn", "k_norm"), (L, hd), "gain", 0.0
    yield ("layers", "ffn", "w_gate"), (L, D, F), "normal", 1 / math.sqrt(D)
    yield ("layers", "ffn", "w_up"), (L, D, F), "normal", 1 / math.sqrt(D)
    yield ("layers", "ffn", "w_down"), (L, F, D), "normal", 1 / math.sqrt(F)


def draw(w: Widths, seed: int, device, dtype: str = "bfloat16") -> Dict:
    """The weight tree of ``w`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    tree: Dict = {}
    for path, shape, init, std in leaves(w):
        t = torch.empty(shape, dtype=DTYPES[dtype], device=device)
        if init == "gain":
            t.uniform_(0.5, 1.5, generator=gen)
        else:
            t.normal_(0.0, std, generator=gen)
        if init == "embed":
            t[w.vocab:] = 0
        elif init == "head":
            t[:, w.vocab:] = 0
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def program_tree(tree: Dict) -> Dict:
    """The tree as the serving model takes it: ``layers`` is a list with
    one entry per superblock position (one here, every layer alike)."""
    out = dict(tree)
    out["layers"] = [tree["layers"]]
    return out


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()
