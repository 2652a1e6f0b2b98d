"""Mamba (SSD / Mamba-2 style) selective state-space mixer.

The chunkwise-parallel SSD form: within a chunk of ``L`` tokens the
recurrence is an attention-like (L x L) masked product; across chunks a
loop carries the (heads, P, N) state.  A per-head scalar decay keeps the
intra-chunk decay matrix (B, nh, L, L).  Decode is the plain recurrence
on the carried state, O(1) a token.

Counterpart of the JAX package's ``models/mamba.py``: same parameters,
same state, same arithmetic; its ``lax.scan`` over chunks is a Python
loop here (``common.sampled``: a counter on ``meta`` runs one chunk and
scales it by the chunk count).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamInit, fill, rms_norm, sampled


def make_mamba_params(pi: ParamInit, n: int, d_model: int, d_state: int,
                      d_conv: int, expand: int, head_p: int = 128):
    """``n`` stacked layers in the reference layout."""
    d_in = expand * d_model
    nh = max(1, d_in // head_p)
    return {
        "in_proj": pi.param((n, d_model, 2 * d_in)),
        "conv_w": pi.param((n, d_conv, d_in), scale=0.5),
        "dt_proj": pi.param((n, d_model, nh), scale=0.5),
        "dt_bias": pi.param((n, nh), init="zeros"),
        "bc_proj": pi.param((n, d_model, 2 * d_state)),
        "a_log": pi.param((n, nh), init="zeros"),
        "d_skip": pi.param((n, nh), init="ones"),
        "norm": pi.param((n, d_in), init="ones"),
        "out_proj": pi.param((n, d_in, d_model)),
    }


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, nh, P, N) inter-chunk SSM state, f32
    conv: torch.Tensor    # (B, d_conv-1, d_in) conv tail


def _segsum_mask(adt: torch.Tensor) -> torch.Tensor:
    """adt: (B, L, nh) per-step log-decays -> (B, nh, L, L) decay matrix
    M[t, s] = exp(sum_{r=s+1..t} adt_r) for s <= t, else 0 (the masked
    entries are exp(-inf): 0, with a zero gradient)."""
    L = adt.shape[1]
    ca = adt.cumsum(1).transpose(1, 2)                 # (B, nh, L)
    diff = ca[:, :, :, None] - ca[:, :, None, :]       # (B, nh, Lt, Ls)
    tri = torch.ones(L, L, dtype=torch.bool, device=adt.device).tril()
    return diff.masked_fill(~tri, float("-inf")).exp()


def _proj_inputs(p, x):
    """x: (B, S, D) -> gated inputs for the SSM."""
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)
    d_in = xz.shape[-1] // 2
    xi, z = xz[..., :d_in], xz[..., d_in:]
    dtv = F.softplus((x @ p["dt_proj"].to(dt)).float()
                     + p["dt_bias"].float())           # (B, S, nh)
    bc = x @ p["bc_proj"].to(dt)
    n = bc.shape[-1] // 2
    return xi, z, dtv, bc[..., :n].float(), bc[..., n:].float()


def _causal_conv(p, xi, tail=None):
    """Depthwise causal conv over seq.  tail: (B, d_conv-1, d_in) context."""
    w = p["conv_w"].to(xi.dtype)                       # (d_conv, d_in)
    dc = w.shape[0]
    if tail is None:
        tail = xi.new_zeros(xi.shape[0], dc - 1, xi.shape[2])
    xp = torch.cat([tail, xi], dim=1)
    S = xi.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, dc):
        out = out + xp[:, i:i + S] * w[i]
    new_tail = xp[:, xp.shape[1] - (dc - 1):] if dc > 1 else tail
    return F.silu(out), new_tail


def _gated_out(p, y, z, x):
    y = rms_norm(y, p["norm"]) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


def mamba_chunked(p, x, *, chunk: int, state: MambaState = None):
    """Full-sequence (train/prefill) chunkwise SSD.  Returns (y, final
    state).  The chunk length is ``chunk`` halved until it divides S."""
    B, S, D = x.shape
    xi, z, dtv, bmat, cmat = _proj_inputs(p, x)
    xi, conv_tail = _causal_conv(p, xi, state.conv if state is not None
                                 else None)
    d_in = xi.shape[-1]
    nh = p["a_log"].shape[0]
    P = d_in // nh
    N = bmat.shape[-1]
    a = -p["a_log"].float().exp()                      # (nh,) negative decay
    L = min(chunk, S)
    while S % L:
        L //= 2
    xh = xi.reshape(B, S, nh, P)
    h = (state.h if state is not None
         else torch.zeros(B, nh, P, N, dtype=torch.float32, device=x.device))
    ys = []
    for c0 in sampled(range(0, S, L), x.device):
        xc, dc_ = xh[:, c0:c0 + L], dtv[:, c0:c0 + L]
        bc_, cc_ = bmat[:, c0:c0 + L], cmat[:, c0:c0 + L]
        adt = dc_ * a                                  # (B, L, nh) log decays
        mask = _segsum_mask(adt)                       # (B, nh, L, L)
        ca = adt.cumsum(1)                             # (B, L, nh)
        # intra-chunk: y[t] = sum_{s<=t} (C_t.B_s) M[t,s] dt_s x_s
        cb = torch.einsum("btn,bsn->bts", cc_, bc_)    # (B, L, L)
        w = cb[:, None] * mask                         # (B, nh, L, L)
        xdt = xc * dc_[..., None].to(xc.dtype)         # (B, L, nh, P)
        y_in = torch.einsum("bhts,bshp->bthp", w.to(xc.dtype), xdt)
        # inter-chunk: y_ext[t] = C_t . (exp(ca_t) h_in)
        y_ext = torch.einsum("btn,bhpn,bth->bthp", cc_, h,
                             ca.exp()).to(xc.dtype)
        # h' = exp(ca_L) h + sum_s exp(ca_L - ca_s) dt_s x_s B_s^T
        dec_end = (ca[:, -1:, :] - ca).exp()           # (B, L, nh)
        hb = torch.einsum("bshp,bsn,bsh->bhpn", xdt.float(), bc_, dec_end)
        h = ca[:, -1].exp()[:, :, None, None] * h + hb
        ys.append(y_in + y_ext)
    y = torch.cat(fill(ys, S // L), dim=1)
    y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
    return _gated_out(p, y.reshape(B, S, d_in), z, x), \
        MambaState(h=h, conv=conv_tail)


def mamba_decode(p, x, state: MambaState):
    """One-token recurrence.  x: (B, 1, D) -> (B, 1, D), new state."""
    B = x.shape[0]
    xi, z, dtv, bmat, cmat = _proj_inputs(p, x)
    xi, conv_tail = _causal_conv(p, xi, state.conv)
    d_in = xi.shape[-1]
    nh = p["a_log"].shape[0]
    P = d_in // nh
    a = -p["a_log"].float().exp()
    adt = dtv[:, 0] * a                                # (B, nh)
    xh = xi[:, 0].reshape(B, nh, P)
    xdt = (xh * dtv[:, 0, :, None].to(xh.dtype)).float()
    hb = torch.einsum("bhp,bn->bhpn", xdt, bmat[:, 0])
    h = adt.exp()[:, :, None, None] * state.h + hb
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], h).to(x.dtype)
    y = y + xh * p["d_skip"].to(y.dtype)[None, :, None]
    return _gated_out(p, y.reshape(B, 1, d_in), z, x), \
        MambaState(h=h, conv=conv_tail)
