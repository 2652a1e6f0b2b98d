"""The benchmark's analytic count of FLOPs and HBM bytes: a prefill, a
decode step and one call of each attention kernel, worked out from a
configuration file's widths alone.

It imports nothing of the program, so a change to the program cannot
move the yardstick it is judged by.  The rules, printed beside every
share that uses them (``ASSUMPTIONS``):

* FLOPs: 2 x matmul parameters x tokens, plus 4 * H * hd for each
  visible (query, key) pair of each layer (QK^T and PV).  The output
  head counts for the last position of a prefill only (the program
  computes nothing else there) and for every row of a decode step.
  Norms, RoPE, activations and softmax are not counted.
* Bytes: every weight the step needs read once (the embedding only as
  the rows gathered), the valid KV read once, the new KV written once,
  the logits written once in f32.  Activations are not counted.
* A kernel call: its inputs read once and its outputs written once;
  FLOPs by the visible-pair formula.
* The bound of a step or call is the larger of FLOPs over the bf16
  tensor-core peak and bytes over the HBM bandwidth (``peaks.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

ASSUMPTIONS = (
    "FLOPs = 2 x matmul params x tokens + 4*H*hd per visible causal pair "
    "per layer; head at the last prompt position in prefill, every row in "
    "decode; norms, rope, activations, softmax not counted. Bytes = each "
    "weight read once (embedding: the gathered rows), valid KV read once, "
    "new KV written once, f32 logits written once; activations not "
    "counted. Bound = max(FLOPs / bf16 peak, bytes / HBM bandwidth).")


@dataclass(frozen=True)
class Widths:
    """What the count needs of a configuration file."""
    layers: int
    d: int
    heads: int
    kv: int
    hd: int
    ff: int
    vocab: int
    qk_norm: bool
    elem: int = 2          # bytes of one weight / cache element (bf16)


def widths(cfg: Dict) -> Widths:
    """The widths of a configuration file (its Hugging Face keys)."""
    heads = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // heads
    return Widths(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                  heads=heads, kv=cfg["num_key_value_heads"], hd=hd,
                  ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                  qk_norm=bool(cfg["qk_norm"]),
                  elem={"bfloat16": 2, "float16": 2,
                        "float32": 4}[cfg["torch_dtype"]])


def visible_pairs(sq: int, skv: int) -> int:
    """Causal (query, key) pairs, the mask aligned bottom-right."""
    off = skv - sq
    if off >= 0:
        return sq * off + sq * (sq + 1) // 2
    return skv * (skv + 1) // 2


def layer_matmul_params(w: Widths) -> int:
    """Q, K, V and O projections and the SwiGLU's three matrices."""
    return (w.d * (w.heads + 2 * w.kv) * w.hd + w.heads * w.hd * w.d
            + 3 * w.d * w.ff)


def layer_norm_params(w: Widths) -> int:
    return 2 * w.d + (2 * w.hd if w.qk_norm else 0)


def _weight_bytes(w: Widths) -> int:
    """Every layer's weights, the final norm and the output head."""
    per_layer = layer_matmul_params(w) + layer_norm_params(w)
    return w.elem * (w.layers * per_layer + w.d + w.d * w.vocab)


def _kv_bytes(w: Widths, rows: int, positions: int) -> int:
    """K and V of ``positions`` positions of ``rows`` rows, every layer."""
    return w.elem * 2 * w.layers * rows * positions * w.kv * w.hd


def prefill(w: Widths, batch: int, seq: int) -> Dict[str, float]:
    """FLOPs and bytes of a prefill of ``batch`` rows of ``seq`` tokens."""
    tokens = batch * seq
    pairs = visible_pairs(seq, seq) * batch
    flops = (2 * layer_matmul_params(w) * tokens * w.layers
             + 4 * w.heads * w.hd * pairs * w.layers
             + 2 * w.d * w.vocab * batch)
    nbytes = (_weight_bytes(w) + w.elem * tokens * w.d
              + 2 * _kv_bytes(w, batch, seq) + 4 * batch * w.vocab)
    return {"flops": float(flops), "bytes": float(nbytes)}


def decode(w: Widths, batch: int, valid: int) -> Dict[str, float]:
    """FLOPs and bytes of one decode step of ``batch`` rows, attending
    over ``valid`` positions (the new token's included)."""
    flops = (2 * layer_matmul_params(w) * batch * w.layers
             + 4 * w.heads * w.hd * valid * batch * w.layers
             + 2 * w.d * w.vocab * batch)
    nbytes = (_weight_bytes(w) + w.elem * batch * w.d
              + _kv_bytes(w, batch, valid) + _kv_bytes(w, batch, 1)
              + 4 * batch * w.vocab)
    return {"flops": float(flops), "bytes": float(nbytes)}


def flash_call(w: Widths, batch: int, seq: int) -> Dict[str, float]:
    """One causal ``flash_attention`` call of a prefill layer: q, k, v
    read and the output written once."""
    flops = 4 * w.heads * w.hd * visible_pairs(seq, seq) * batch
    nbytes = w.elem * batch * seq * w.hd * (2 * w.heads + 2 * w.kv)
    return {"flops": float(flops), "bytes": float(nbytes)}


def paged_call(w: Widths, batch: int, valid: int) -> Dict[str, float]:
    """One ``paged_attention`` call of a decode layer: q read, the valid
    K and V read and the output written once."""
    flops = 4 * w.heads * w.hd * valid * batch
    nbytes = w.elem * batch * w.hd * (2 * w.heads + 2 * w.kv * valid)
    return {"flops": float(flops), "bytes": float(nbytes)}


def bound_s(cost: Dict[str, float], peak_flops: float,
            peak_bw: float) -> float:
    """The least time at the peaks: the larger of the two bounds."""
    return max(cost["flops"] / peak_flops, cost["bytes"] / peak_bw)


def bound_kind(cost: Dict[str, float], peak_flops: float,
               peak_bw: float) -> str:
    return ("compute" if cost["flops"] / peak_flops
            >= cost["bytes"] / peak_bw else "memory")
