"""The port's recurrent mixers held against the JAX package's on the CPU
in float32: mamba (chunked and decode, the state carried across calls, at
a sequence length the chunk does not divide), mLSTM (chunked and decode),
sLSTM (sequence and decode) and the sLSTM's deferred-reduction backward
(``SLSTMScan``) against the reference's ``custom_vjp`` and against plain
autograd through the loop; then xlstm-350m (3 mLSTM to 1 sLSTM) at
reduced size (tests/_torch_family.py).  The hybrid, jamba-1.5-large, is
in tests/test_torch_jamba.py.

Bound: 2e-5 + 2e-5 x |ref| (the f32 bound of tests/test_kernels.py);
gradients and losses keep the bounds of tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as RM
from repro.models import xlstm as RX
from repro.models.common import ParamBuilder, split_tree
from repro_torch.models import mamba as PM
from repro_torch.models import xlstm as PX

import _torch_family as FAM

XLSTM = ["xlstm-350m"]


def _params(make, *args, seed=0):
    pb = ParamBuilder(jax.random.PRNGKey(seed), False, jnp.float32)
    p, _ = split_tree(make(pb, *args))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _states_close(got, want, what):
    assert type(got).__name__ == type(want).__name__
    for name, a, b in zip(want._fields, got, want):
        FAM.close(a, b, what=f"{what} state {name}")


# ------------------------------------------------------------------ mamba
def test_mamba_chunked_and_decode_carry_state():
    """40 tokens (chunk 16 halves to 8), then 12 more from the carried
    state (halves to 4), then 4 decode steps; and 24 tokens (chunk 8) in
    one call."""
    p, tp = _params(RM.make_mamba_params, 64, 8, 4, 2)
    xj, xt = _x((2, 56, 64), seed=1)
    yj, sj = RM.mamba_chunked(p, xj[:, :40], chunk=16)
    yt, st = PM.mamba_chunked(tp, xt[:, :40], chunk=16)
    FAM.close(yt, yj, what="mamba_chunked")
    _states_close(st, sj, "mamba_chunked")
    yj, sj = RM.mamba_chunked(p, xj[:, 40:52], chunk=16, state=sj)
    yt, st = PM.mamba_chunked(tp, xt[:, 40:52], chunk=16, state=st)
    FAM.close(yt, yj, what="mamba_chunked from a state")
    _states_close(st, sj, "mamba_chunked from a state")
    for t in range(52, 56):
        yj, sj = RM.mamba_decode(p, xj[:, t:t + 1], sj)
        yt, st = PM.mamba_decode(tp, xt[:, t:t + 1], st)
        FAM.close(yt, yj, what=f"mamba_decode at {t}")
        _states_close(st, sj, f"mamba_decode at {t}")
    yj, sj = RM.mamba_chunked(p, xj[:, :24], chunk=16)
    yt, st = PM.mamba_chunked(tp, xt[:, :24], chunk=16)
    FAM.close(yt, yj, what="mamba_chunked at 24")
    _states_close(st, sj, "mamba_chunked at 24")


def test_mamba_masked_decay_has_finite_gradients():
    """The segsum mask's exp(-inf) entries give 0, and 0 gradient."""
    adt = (-torch.rand(2, 8, 3, dtype=torch.float64)).requires_grad_()
    mask = PM._segsum_mask(adt)
    assert torch.equal(mask[..., 0, 1:], torch.zeros_like(mask[..., 0, 1:]))
    mask.sum().backward()
    assert torch.isfinite(adt.grad).all()
    assert torch.autograd.gradcheck(PM._segsum_mask, (adt.detach()
                                                     .requires_grad_(),))


# ------------------------------------------------------------------ mLSTM
def test_mlstm_chunked_and_decode_carry_state():
    p, tp = _params(RX.make_mlstm_params, 64, 4)
    xj, xt = _x((2, 44, 64), seed=2)
    yj, sj = RX.mlstm_chunked(p, xj[:, :40], chunk=16, n_heads=4)
    yt, st = PX.mlstm_chunked(tp, xt[:, :40], chunk=16, n_heads=4)
    FAM.close(yt, yj, what="mlstm_chunked")
    _states_close(st, sj, "mlstm_chunked")
    for t in range(40, 44):
        yj, sj = RX.mlstm_decode(p, xj[:, t:t + 1], sj, n_heads=4)
        yt, st = PX.mlstm_decode(tp, xt[:, t:t + 1], st, n_heads=4)
        FAM.close(yt, yj, what=f"mlstm_decode at {t}")
        _states_close(st, sj, f"mlstm_decode at {t}")
    yj, _ = RX.mlstm_chunked(p, xj[:, 40:], chunk=16, n_heads=4,
                             state=RX.init_mlstm_state(2, 64, 4))
    yt, _ = PX.mlstm_chunked(tp, xt[:, 40:], chunk=16, n_heads=4,
                             state=PX.init_mlstm_state(2, 64, 4, "cpu"))
    FAM.close(yt, yj, what="mlstm_chunked from an initial state")


# ------------------------------------------------------------------ sLSTM
def test_slstm_seq_and_decode_carry_state():
    p, tp = _params(RX.make_slstm_params, 64, 4)
    xj, xt = _x((2, 20, 64), seed=3)
    yj, sj = RX.slstm_seq(p, xj[:, :16])
    yt, st = PX.slstm_seq(tp, xt[:, :16])
    FAM.close(yt, yj, what="slstm_seq")
    _states_close(st, sj, "slstm_seq")
    for t in range(16, 20):
        yj, sj = RX.slstm_decode(p, xj[:, t:t + 1], sj)
        yt, st = PX.slstm_decode(tp, xt[:, t:t + 1], st)
        FAM.close(yt, yj, what=f"slstm_decode at {t}")
        _states_close(st, sj, f"slstm_decode at {t}")


def _port_plain_seq(p, x):
    """sLSTM through plain autograd over the loop (no ``SLSTMScan``)."""
    B, S, D = x.shape
    st = PX.init_slstm_state(B, D, x.device)
    xin = x @ p["w_in"]
    hs = []
    for t in range(S):
        st = PX._slstm_cell(p, xin[:, t], st)
        hs.append(st.h)
    return PX._slstm_ffn(p, torch.stack(hs, 1), x)


def test_slstm_function_gradients_match_reference_and_autograd():
    """``SLSTMScan``'s gradients (every parameter and the input) against
    the reference's ``custom_vjp`` and against plain autograd through the
    loop, as tests/test_kernels.py holds the reference; the final state's
    cotangents flow too (the loss reads it)."""
    p, tp = _params(RX.make_slstm_params, 64, 4)
    xj, xt = _x((2, 16, 64), seed=4)

    def ref_loss(p, x):
        y, st = RX.slstm_seq(p, x)
        return y.sum() + (st.c * st.n).sum() + st.m.sum() * 1e-3

    gj_p, gj_x = jax.grad(ref_loss, argnums=(0, 1))(p, xj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = xt.clone().requires_grad_(True)
    y, st = PX.slstm_seq(leaves, x)
    (y.sum() + (st.c * st.n).sum() + st.m.sum() * 1e-3).backward()
    for k in tp:
        FAM.close(leaves[k].grad, gj_p[k], what=f"d{k} vs custom_vjp")
    FAM.close(x.grad, gj_x, what="dx vs custom_vjp")
    leaves2 = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x2 = xt.clone().requires_grad_(True)
    _port_plain_seq(leaves2, x2).sum().backward()
    leaves3 = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x3 = xt.clone().requires_grad_(True)
    PX.slstm_seq(leaves3, x3)[0].sum().backward()
    for k in tp:
        FAM.close(leaves3[k].grad, leaves2[k].grad.numpy(),
                  what=f"d{k} vs autograd")
    FAM.close(x3.grad, x2.grad.numpy(), what="dx vs autograd")


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", XLSTM)
def test_forward_logits_match_reference(arch):
    FAM.check_forward(arch)


@pytest.mark.parametrize("arch", XLSTM)
def test_prefill_logits_and_cache_match_reference(arch):
    FAM.check_prefill(arch)


@pytest.mark.parametrize("arch", XLSTM)
def test_six_decode_steps_match_reference(arch):
    FAM.check_decode(arch)


@pytest.mark.parametrize("arch", XLSTM)
def test_loss_and_gradients_match_reference(arch):
    FAM.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", XLSTM)
def test_one_train_step_matches_reference(arch):
    FAM.check_train_step(arch)


@pytest.mark.parametrize("arch", XLSTM)
def test_param_stats_and_counts_match_reference(arch):
    FAM.check_param_stats(arch)
