"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly sequential).

mLSTM is attention with decay: C_t = f_t C_{t-1} + i_t v_t k_t^T,
y_t = C_t q_t / max(|n_t q_t|, exp(-m_t)).  Per-head scalar log-forget
gates make the intra-chunk decay a (L x L) mask, as in mamba's SSD form;
the exponential input gates are stabilised by the running max m_t.

sLSTM's recurrent weights make it sequential: a loop over time.  Its
training backward is ``SLSTMScan``, an ``autograd.Function`` whose reverse
loop takes each step's cell VJP in closed form (``_slstm_gates_vjp``),
carries only the gate cotangents out of the loop and forms the recurrent
matrix's gradient as one matmul after it (and the bias's as one sum): the
reference's deferred-reduction ``custom_vjp``.

Serving on the card replays CUDA graphs of ``GRAPH_STEPS`` sLSTM steps
(``_scan_graphed``): a step is about 20 small kernels, and eagerly each
costs a host launch.

Counterpart of the JAX package's ``models/xlstm.py``; its ``lax.scan``
loops are Python loops here (``common.sampled``: a counter on ``meta``
runs one chunk or step and scales it by the trip count).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamInit, fill, rms_norm, sampled

M_INIT = -1e30          # the stabiliser's start (log domain)


# ----------------------------------------------------------------- mLSTM ---
def make_mlstm_params(pi: ParamInit, n: int, d_model: int, n_heads: int,
                      proj_factor: float = 2.0):
    d_in = int(d_model * proj_factor)
    return {
        "up_proj": pi.param((n, d_model, 2 * d_in)),
        "wq": pi.param((n, d_in, d_in)),
        "wk": pi.param((n, d_in, d_in)),
        "wv": pi.param((n, d_in, d_in)),
        "w_if": pi.param((n, d_in, 2 * n_heads), scale=0.5),
        "b_if": pi.param((n, 2 * n_heads), init="zeros"),
        "norm": pi.param((n, d_in), init="ones"),
        "down_proj": pi.param((n, d_in, d_model)),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, nh, P, P) matrix memory
    n: torch.Tensor   # (B, nh, P)    normalizer
    m: torch.Tensor   # (B, nh)       gate stabilizer (log domain)


def init_mlstm_state(batch: int, d_model: int, n_heads: int, device,
                     proj_factor: float = 2.0) -> MLSTMState:
    P = int(d_model * proj_factor) // n_heads
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return MLSTMState(c=z(batch, n_heads, P, P), n=z(batch, n_heads, P),
                      m=torch.full((batch, n_heads), M_INIT,
                                   dtype=torch.float32, device=device))


def _mlstm_qkvif(p, x, nh: int):
    dt = x.dtype
    xz = x @ p["up_proj"].to(dt)
    d_in = xz.shape[-1] // 2
    xi, z = xz[..., :d_in], xz[..., d_in:]
    B, S = xi.shape[:2]
    P = d_in // nh
    q = (xi @ p["wq"].to(dt)).reshape(B, S, nh, P)
    k = (xi @ p["wk"].to(dt)).reshape(B, S, nh, P) * (P ** -0.5)
    v = (xi @ p["wv"].to(dt)).reshape(B, S, nh, P)
    gif = (xi @ p["w_if"].to(dt)).float() + p["b_if"].float()
    ig, fg = gif[..., :nh], gif[..., nh:]      # (B, S, nh) log-domain gates
    return q, k, v, ig, F.logsigmoid(fg), z, d_in


def _mlstm_out(p, y, z, x):
    y = rms_norm(y, p["norm"]) * F.silu(z)
    return y @ p["down_proj"].to(x.dtype)


def mlstm_chunked(p, x, *, chunk: int, n_heads: int, state=None):
    """Full-sequence chunkwise mLSTM.  Returns (y, final state)."""
    B, S, D = x.shape
    q, k, v, ig, logf, z, d_in = _mlstm_qkvif(p, x, n_heads)
    L = min(chunk, S)
    while S % L:
        L //= 2
    c, n, m = (state if state is not None
               else init_mlstm_state(B, D, n_heads, x.device))
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in sampled(range(0, S, L), x.device):
        qc, kc, vc = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        igc, lfc = ig[:, c0:c0 + L], logf[:, c0:c0 + L]
        clf = lfc.cumsum(1)                    # (B, L, nh) cumulative log-f
        # m_t = max(m_prev + clf_t, max_{s<=t}(clf_t - clf_s + ig_s))
        a_run = torch.cummax(igc - clf, dim=1).values
        m_t = clf + torch.maximum(m[:, None], a_run)
        # intra-chunk weights exp(clf_t - clf_s + ig_s - m_t), (B, nh, Lt, Ls)
        clf_h, ig_h = clf.transpose(1, 2), igc.transpose(1, 2)
        dmat = clf_h[:, :, :, None] - clf_h[:, :, None, :] + \
            ig_h[:, :, None, :]
        dmat = dmat.masked_fill(~tri, float("-inf"))
        w = (dmat - m_t.transpose(1, 2)[:, :, :, None]).exp()
        # k is pre-scaled by P**-0.5, and so are the c / n sums
        qk = torch.einsum("bthp,bshp->bhts", qc.float(), kc.float())
        aw = w * qk
        y_in = torch.einsum("bhts,bshp->bthp", aw.to(vc.dtype), vc)
        qn_in = aw.sum(-1).transpose(1, 2)     # (B, L, nh)
        # inter-chunk contribution: decay exp(clf_t + m_prev - m_t)
        dec = (clf + m[:, None] - m_t).exp()
        qf = qc.float()
        y_ext = torch.einsum("bthp,bhrp,bth->bthr", qf, c, dec).to(vc.dtype)
        n_ext = torch.einsum("bthp,bhp,bth->bth", qf, n, dec)
        y = y_in.float() + y_ext.float()
        qn = (qn_in + n_ext).abs()
        y = y / torch.maximum(qn, (-m_t).exp())[..., None]
        # carry update at the chunk's end
        m_end = m_t[:, -1]                     # (B, nh)
        dec_end = (clf[:, -1:, :] - clf + igc - m_end[:, None]).exp()
        kf = kc.float()
        kv = torch.einsum("bshp,bshr,bsh->bhrp", kf, vc.float(), dec_end)
        f_end = (clf[:, -1] + m - m_end).exp()
        c = f_end[:, :, None, None] * c + kv
        n = f_end[:, :, None] * n + torch.einsum("bshp,bsh->bhp", kf,
                                                 dec_end)
        m = m_end
        ys.append(y.to(x.dtype))
    y = torch.cat(fill(ys, S // L), dim=1).reshape(B, S, d_in)
    return _mlstm_out(p, y, z, x), MLSTMState(c=c, n=n, m=m)


def mlstm_decode(p, x, state: MLSTMState, *, n_heads: int):
    B = x.shape[0]
    q, k, v, ig, logf, z, d_in = _mlstm_qkvif(p, x, n_heads)
    q1, k1, v1 = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ig1, lf1 = ig[:, 0], logf[:, 0]            # (B, nh)
    m_new = torch.maximum(lf1 + state.m, ig1)
    fdec = (lf1 + state.m - m_new).exp()
    idec = (ig1 - m_new).exp()
    c = fdec[:, :, None, None] * state.c + \
        idec[:, :, None, None] * torch.einsum("bhr,bhp->bhrp", v1, k1)
    n = fdec[:, :, None] * state.n + idec[:, :, None] * k1
    num = torch.einsum("bhrp,bhp->bhr", c, q1)
    den = torch.einsum("bhp,bhp->bh", n, q1).abs()
    y = num / torch.maximum(den, (-m_new).exp())[..., None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    return _mlstm_out(p, y, z, x), MLSTMState(c=c, n=n, m=m_new)


# ----------------------------------------------------------------- sLSTM ---
def make_slstm_params(pi: ParamInit, n: int, d_model: int, n_heads: int,
                      ffn_factor: float = 4 / 3):
    dp = int(d_model * ffn_factor)
    return {
        "w_in": pi.param((n, d_model, 4 * d_model)),
        "w_rec": pi.param((n, d_model, 4 * d_model), scale=0.5),
        "b": pi.param((n, 4 * d_model), init="zeros"),
        "norm": pi.param((n, d_model), init="ones"),
        "up": pi.param((n, d_model, dp)),
        "down": pi.param((n, dp, d_model)),
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, D)
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)


def init_slstm_state(batch: int, d_model: int, device) -> SLSTMState:
    z = lambda: torch.zeros(batch, d_model, dtype=torch.float32,
                            device=device)
    return SLSTMState(h=z(), c=z(), n=z(),
                      m=torch.full((batch, d_model), M_INIT,
                                   dtype=torch.float32, device=device))


def _slstm_gates(g, st: SLSTMState) -> SLSTMState:
    """Cell update from the full gate pre-activation g (B, 4D), f32."""
    i, f, zg, o = g.chunk(4, dim=-1)
    logf = F.logsigmoid(f)
    lfm = logf + st.m
    m_new = torch.maximum(lfm, i)
    idec = (i - m_new).exp()
    fdec = (lfm - m_new).exp()
    c = fdec * st.c + idec * zg.tanh()
    n = fdec * st.n + idec
    # torch.maximum, not clamp_min: at a tie (n = 1 at the first step) it
    # splits the gradient in halves, as jnp.maximum does
    h = o.sigmoid() * c / torch.maximum(n, n.new_ones(()))
    return SLSTMState(h=h, c=c, n=n, m=m_new)


def _pre(w_rec, b, xt, h):
    """The gate pre-activation of one step, f32 (the recurrent product in
    the weights' dtype, as the reference takes it)."""
    return xt.float() + (h.to(w_rec.dtype) @ w_rec).float() + b.float()


def _slstm_cell(p, xt, st: SLSTMState) -> SLSTMState:
    """One sLSTM step.  xt: (B, 4D) pre-projected input contribution."""
    return _slstm_gates(_pre(p["w_rec"], p["b"], xt, st.h), st)


def _tie(a, b):
    """d max(a, b) / da: 1 where a > b, 0 where a < b and 1/2 at a tie,
    the split of ``jnp.maximum``'s (and ``torch.maximum``'s) gradient."""
    return (a > b).float() + 0.5 * (a == b).float()


def _slstm_gates_vjp(g, st: SLSTMState, dst):
    """The VJP of ``_slstm_gates`` at (g, st) for the cotangents ``dst`` =
    (dh, dc, dn, dm) of its output: (dg, (dc, dn, dm) of st).  The gates
    are recomputed from g; st.h does not enter them."""
    i, f, zg, o = g.chunk(4, dim=-1)
    lfm = F.logsigmoid(f) + st.m
    m_new = torch.maximum(lfm, i)
    idec = (i - m_new).exp()
    fdec = (lfm - m_new).exp()
    tz = zg.tanh()
    c = fdec * st.c + idec * tz
    n = fdec * st.n + idec
    nm = torch.maximum(n, n.new_ones(()))
    so = o.sigmoid()
    dh, dc, dn, dm = dst
    r = dh / nm
    dc = dc + r * so
    dso = r * c
    dn = dn - dso * so / nm * _tie(n, 1.0)
    didec = (dc * tz + dn) * idec
    dfdec = (dc * st.c + dn * st.n) * fdec
    dm = dm - didec - dfdec
    w = _tie(lfm, i)
    dlfm = dfdec + dm * w
    dg = torch.cat([didec + dm * (1 - w), dlfm * (-f).sigmoid(),
                    dc * idec * (1 - tz * tz), dso * so * (1 - so)], dim=-1)
    return dg, (dc * fdec, dn * fdec, dlfm)


class SLSTMScan(torch.autograd.Function):
    """The sequential sLSTM over time: (w_rec, b, xin (S, B, 4D), h0, c0,
    n0, m0) -> (h_seq (S, B, D), hT, cT, nT, mT).

    Backward: a reverse loop takes each step's cell VJP
    (``_slstm_gates_vjp``) and carries the state cotangent back; the gate
    cotangents ``dg`` leave the loop, and dW = h_prevᵀ dg and db = Σ dg
    are each formed once after it."""

    @staticmethod
    def forward(ctx, w_rec, b, xin, h0, c0, n0, m0):
        st = SLSTMState(h0, c0, n0, m0)
        prev, gs, hs = [], [], []
        S = xin.shape[0]
        for t in sampled(range(S), xin.device):
            prev.append(st)
            gs.append(_pre(w_rec, b, xin[t], st.h))
            st = _slstm_gates(gs[-1], st)
            hs.append(st.h)
        if any(ctx.needs_input_grad):
            # h, c, n, m (S, B, D)
            seq = [torch.stack(fill(list(x), S)) for x in zip(*prev)]
            ctx.save_for_backward(w_rec, b, torch.stack(fill(gs, S)), *seq)
            ctx.xin_dtype = xin.dtype
        return (torch.stack(fill(hs, S)),) + tuple(st)

    @staticmethod
    def backward(ctx, dh_seq, dhT, dcT, dnT, dmT):
        w_rec, b, g_seq, *seq = ctx.saved_tensors
        z = lambda t, like: torch.zeros_like(like) if t is None else t
        dh = z(dhT, seq[0][0])
        dst = (z(dcT, seq[1][0]), z(dnT, seq[2][0]), z(dmT, seq[3][0]))
        dh_seq = z(dh_seq, seq[0])
        w_t = w_rec.t()
        S = g_seq.shape[0]
        dgs = []                                           # last step first
        for t in sampled(range(S - 1, -1, -1), g_seq.device):
            dg, dst = _slstm_gates_vjp(
                g_seq[t], SLSTMState(*(s[t] for s in seq)),
                (dh + dh_seq[t],) + dst)
            dh = (dg.to(w_rec.dtype) @ w_t).float()
            dgs.append(dg)
        dg_seq = torch.stack(fill(dgs, S)[::-1])           # (S, B, 4D)
        dW = torch.einsum("sbd,sbe->de", seq[0].float(), dg_seq) \
            .to(w_rec.dtype)
        db = dg_seq.sum((0, 1)).to(b.dtype)
        return dW, db, dg_seq.to(ctx.xin_dtype), dh, *dst


GRAPH_STEPS = 64        # sLSTM steps one CUDA graph replays


class _GraphedSteps:
    """``GRAPH_STEPS`` sLSTM steps captured as one CUDA graph for one
    (device, B, D, dtypes): static buffers for w_rec, b, a chunk of the
    input and the carried state, and the chunk's h as the graph's output.
    A replay launches the chunk's ~20 small kernels a step at once, where
    eager mode pays the host's launch cost for each."""

    def __init__(self, w_rec, b, xin, st):
        self.w, self.b = torch.empty_like(w_rec), torch.empty_like(b)
        self.x = xin.new_zeros((GRAPH_STEPS,) + tuple(xin.shape[1:]))
        self.st = [torch.zeros_like(t) for t in st]
        side = torch.cuda.Stream(device=xin.device)
        side.wait_stream(torch.cuda.current_stream(xin.device))
        with torch.cuda.stream(side):
            self._steps()               # warm-up outside the capture
        torch.cuda.current_stream(xin.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.hs = self._steps()

    def _steps(self):
        st = SLSTMState(*self.st)
        hs = []
        for j in range(GRAPH_STEPS):
            st = _slstm_gates(_pre(self.w, self.b, self.x[j], st.h), st)
            hs.append(st.h)
        for buf, new in zip(self.st, st):
            buf.copy_(new)
        return torch.stack(hs)


_GRAPHS = {}


def _scan_graphed(w_rec, b, xin, st: SLSTMState):
    """``SLSTMScan``'s forward without autograd on a CUDA device: whole
    chunks of ``GRAPH_STEPS`` steps replay a captured graph, the rest run
    eagerly.  Returns (h_seq (S, B, D), final state)."""
    key = (xin.device, tuple(xin.shape[1:]), xin.dtype, w_rec.dtype,
           tuple(w_rec.shape), b.dtype)
    if key not in _GRAPHS:
        _GRAPHS[key] = _GraphedSteps(w_rec, b, xin, st)
    gs = _GRAPHS[key]
    gs.w.copy_(w_rec)
    gs.b.copy_(b)
    for buf, t in zip(gs.st, st):
        buf.copy_(t)
    S = xin.shape[0]
    full = S - S % GRAPH_STEPS
    hs = []
    for t0 in range(0, full, GRAPH_STEPS):
        gs.x.copy_(xin[t0:t0 + GRAPH_STEPS])
        gs.graph.replay()
        hs.append(gs.hs.clone())
    st = SLSTMState(*(t.clone() for t in gs.st))
    for t in range(full, S):
        st = _slstm_gates(_pre(w_rec, b, xin[t], st.h), st)
        hs.append(st.h[None])
    return torch.cat(hs), st


def _slstm_ffn(p, y, x):
    y = rms_norm(y, p["norm"])
    y = F.gelu(y @ p["up"].to(x.dtype), approximate="tanh")
    return y @ p["down"].to(x.dtype)


def slstm_seq(p, x, state=None):
    """x: (B, S, D) -> (B, S, D) and the final state, sequential over
    time: ``SLSTMScan`` under autograd or on the CPU, else (serving on the
    card) ``_scan_graphed``."""
    B, S, D = x.shape
    st = state if state is not None else init_slstm_state(B, D, x.device)
    xin = x @ p["w_in"].to(x.dtype)
    args = (p["w_rec"], p["b"], xin.transpose(0, 1), *st)
    if x.is_cuda and not (torch.is_grad_enabled()
                          and any(t.requires_grad for t in args)):
        hs, stT = _scan_graphed(*args[:3], st)
    else:
        hs, *stT = SLSTMScan.apply(*args)
    return _slstm_ffn(p, hs.transpose(0, 1).to(x.dtype), x), \
        SLSTMState(*stT)


def slstm_decode(p, x, state: SLSTMState):
    xin = x @ p["w_in"].to(x.dtype)
    st2 = _slstm_cell(p, xin[:, 0], state)
    return _slstm_ffn(p, st2.h.to(x.dtype)[:, None], x), st2
