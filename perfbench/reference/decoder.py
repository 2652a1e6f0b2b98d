"""A plain float32 dense decoder: RMSNorm, RoPE (rotate-half), grouped
query attention with an optional per-head RMS norm of q and k (Qwen3),
SwiGLU, an untied output head.  No cache, no batching of rows, no
kernel: a full causal forward pass over each sequence.

It reads the configuration file's published keys itself and takes the
weight tree the benchmark drew (each leaf stacked over the layers:
``wq`` (L, D, H, hd), ``wk``/``wv`` (L, D, KV, hd), ``wo`` (L, H, hd,
D), ``w_gate``/``w_up`` (L, D, F), ``w_down`` (L, F, D), gains ``ln1``,
``ln2`` (L, D), ``q_norm``/``k_norm`` (L, hd), ``final_norm`` (D,),
``embed`` (V', D), ``lm_head`` (D, V'); rows and columns past the
published vocabulary are ignored).  It imports nothing of the program.

To fit beside the weights on one card it goes layer by layer, casting
one matrix at a time to float32, over every sequence of the sample at
once.  Positions that all sequences share at their start are computed
once (``common_prefix``): a causal pass gives them the same states
whichever sequence they begin, so the result is that of each sequence's
own full pass.  Attention runs in blocks of heads.  TF32 is off.

``precision="fp8"`` is the control: every product with a weight matrix
takes its weight rounded to float8 e4m3 with a scale per output column,
and its input rounded likewise with a scale per row (W8A8), the rest as
above.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Sequence

import numpy as np
import torch

FP8_MAX = 448.0             # largest finite float8 e4m3fn value


@contextmanager
def no_tf32():
    """float32 products in float32: TF32 off, then restored."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float().mul_(scale)


class Decoder:
    """The published architecture of one configuration file."""

    def __init__(self, cfg: Dict, weights: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.L = cfg["num_hidden_layers"]
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KV = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.D // self.H
        self.V = cfg["vocab_size"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.qk_norm = bool(cfg["qk_norm"])
        self.w = weights
        self.fp8 = precision == "fp8"

    # ---------------------------------------------------------- pieces --
    def _mat(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        m = t.float().reshape(rows, -1)
        return _fp8(m, 0) if self.fp8 else m

    def _mm(self, x: torch.Tensor, w: torch.Tensor, rows: int):
        if self.fp8:
            x = _fp8(x, 1)
        return x @ self._mat(w, rows)

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * gain.float()

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (N, heads, hd) at positions ``pos`` (N,)."""
        half = self.hd // 2
        inv = 1.0 / self.theta ** (torch.arange(0, half, device=x.device,
                                                dtype=torch.float64) / half)
        ang = (pos.double()[:, None] * inv).float()
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attend(self, q, k, v, q0: int) -> torch.Tensor:
        """q (Sq, H, hd) at positions q0.. over k, v (Skv, KV, hd) at
        positions 0..: causal softmax attention, in blocks of heads."""
        Sq, Skv, G = q.shape[0], k.shape[0], self.H // self.KV
        qpos = q0 + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] > qpos[:, None]
        out = torch.empty_like(q)
        step = max(1, min(self.KV, (1 << 28) // max(1, Sq * Skv * G)))
        for k0 in range(0, self.KV, step):
            k1 = min(self.KV, k0 + step)
            qg = q[:, k0 * G:k1 * G].reshape(Sq, k1 - k0, G, self.hd)
            s = torch.einsum("qkgd,skd->kgqs", qg, k[:, k0:k1])
            s = s * self.hd ** -0.5
            s = s.masked_fill(mask, float("-inf")).softmax(dim=-1)
            o = torch.einsum("kgqs,skd->qkgd", s, v[:, k0:k1])
            out[:, k0 * G:k1 * G] = o.reshape(Sq, (k1 - k0) * G, self.hd)
        return out

    def _layer(self, l: int, x: torch.Tensor, pos: torch.Tensor,
               spans: List[tuple]) -> torch.Tensor:
        """Layer ``l`` over every position of ``x`` (N, D).  ``spans``:
        (start, stop, kv_start, q0) of each causal run of rows: rows
        start..stop are at positions q0.. and see keys of the rows
        kv_start..start (a shared prefix, or none) and start..stop."""
        lw = self.w["layers"]
        a = lw["attn"]
        H, KV, hd, D = self.H, self.KV, self.hd, self.D
        h = self._norm(x, lw["ln1"][l])
        q = self._mm(h, a["wq"][l], D).reshape(-1, H, hd)
        k = self._mm(h, a["wk"][l], D).reshape(-1, KV, hd)
        v = self._mm(h, a["wv"][l], D).reshape(-1, KV, hd)
        if self.qk_norm:
            q = self._norm(q, a["q_norm"][l])
            k = self._norm(k, a["k_norm"][l])
        q, k = self._rope(q, pos), self._rope(k, pos)
        o = torch.empty_like(q)
        for start, stop, kv_start, q0 in spans:
            ks = torch.cat([k[kv_start:kv_start + q0], k[start:stop]])
            vs = torch.cat([v[kv_start:kv_start + q0], v[start:stop]])
            o[start:stop] = self._attend(q[start:stop], ks, vs, q0)
        x = x + self._mm(o.reshape(-1, H * hd), a["wo"][l], H * hd)
        f = lw["ffn"]
        h = self._norm(x, lw["ln2"][l])
        g = torch.nn.functional.silu(self._mm(h, f["w_gate"][l], D))
        g.mul_(self._mm(h, f["w_up"][l], D))
        del h
        return x + self._mm(g, f["w_down"][l], g.shape[1])

    # ------------------------------------------------------------ entry --
    def logits(self, seqs: Sequence[np.ndarray],
               want: Sequence[range]) -> List[torch.Tensor]:
        """For each sequence, the logits (len(want[i]), V) in float32 of
        the positions in ``want[i]`` (the logits at position t predict
        token t + 1)."""
        dev = self.w["embed"].device
        p0 = common_prefix(seqs, min(r.start for r in want))
        rows = [np.asarray(seqs[0][:p0])] + [np.asarray(s[p0:])
                                             for s in seqs]
        tokens = torch.as_tensor(np.concatenate(rows).astype(np.int64),
                                 device=dev)
        pos, spans, at = [torch.arange(p0)], [(0, p0, 0, 0)], p0
        for s in seqs:
            n = len(s) - p0
            pos.append(torch.arange(p0, p0 + n))
            spans.append((at, at + n, 0, p0))
            at += n
        pos = torch.cat(pos).to(dev)
        with no_tf32(), torch.no_grad():
            x = self.w["embed"][tokens].float()
            for l in range(self.L):
                x = self._layer(l, x, pos, spans)
            out = []
            for (start, _stop, _kv, _q0), r in zip(spans[1:], want):
                rows_at = torch.as_tensor([start + t - p0 for t in r],
                                          device=dev)
                h = self._norm(x[rows_at], self.w["final_norm"])
                head = self.w["lm_head"][:, :self.V]
                out.append(self._mm(h, head, self.D))
        return out


def common_prefix(seqs: Sequence[np.ndarray], limit: int) -> int:
    """Length of the prefix every sequence shares, at most ``limit``."""
    n = min(limit, *(len(s) for s in seqs))
    first = np.asarray(seqs[0][:n])
    for s in seqs[1:]:
        diff = np.nonzero(np.asarray(s[:n]) != first)[0]
        if len(diff):
            n = int(diff[0])
            first = first[:n]
    return n
