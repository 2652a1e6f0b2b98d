"""The port's mixture of experts held against the JAX package's on the CPU
in float32: ``moe_ffn`` on draws where capacity drops (token, slot) pairs
and on a decode-sized batch at kimi-k2's routing (384 experts, top 8, a
capacity of 1), with an equal kept set; and the two MoE configs,
kimi-k2-1t-a32b and arctic-480b (a dense residual FFN beside the
experts), at reduced size: forward, prefill, 6 decode steps, loss and
gradients, one train step, parameter counts (tests/_torch_family.py).

The reference's routing runs inside a ``shard_map``; ``ref_routing`` is
its routing lines (``src/repro/models/ffn.py``, ``local``) on one shard,
the kept set it computes.  Bounds: outputs within 2e-5 + 2e-5 x |ref|.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh
from repro.models import ffn as RF
from repro.models.common import ParamBuilder, split_tree
from repro.models.sharding import BASELINE_RULES
from repro_torch.models import ffn as PF
from repro_torch.models.common import ParamInit

import _torch_family as FAM

MOE = ["kimi-k2-1t-a32b", "arctic-480b"]


def ref_routing(router, x, E, k, cf):
    """(idx, pos, keep) of the reference's ``moe_ffn`` on one shard."""
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    cap = max(1, int(math.ceil(T * k / E * cf)))
    probs = jax.nn.softmax((xt @ router).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(T * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - 1) * flat, -1).reshape(T, k)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


def _moe_pair(D, E, k, F, seed):
    pb = ParamBuilder(jax.random.PRNGKey(seed), False, jnp.float32)
    p, _ = split_tree(RF.make_moe_params(pb, D, E, F))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return p, tp


@pytest.mark.parametrize("Bx,Sx,D,E,k,F,cf,zero_rows", [
    (2, 40, 64, 4, 2, 32, 1.25, 0),      # the reduced configs' routing
    (4, 64, 32, 8, 2, 16, 0.5, 0),       # half the capacity: many drops
    (1, 24, 32, 4, 1, 16, 1.0, 6),       # all-zero rows: tied experts
    (4, 1, 64, 384, 8, 16, 1.25, 0),     # kimi's decode routing, cap 1
])
def test_moe_ffn_matches_reference_with_equal_kept_set(Bx, Sx, D, E, k, F,
                                                       cf, zero_rows):
    p, tp = _moe_pair(D, E, k, F, seed=Bx * 7 + E)
    x = np.random.default_rng(E).standard_normal((Bx, Sx, D)) \
        .astype(np.float32)
    x.reshape(-1, D)[:zero_rows] = 0.0
    ctx = RF.MoEContext(make_host_mesh((1, 1), ("data", "model")),
                        BASELINE_RULES, E, k, cf)
    want = RF.moe_ffn(ctx, p, jnp.asarray(x))
    pctx = PF.MoEContext(E, k, cf)
    got = PF.moe_ffn(pctx, tp, torch.from_numpy(x))
    FAM.close(got, want, what="moe_ffn output")
    idx, pos, keep = ref_routing(p["router"], jnp.asarray(x), E, k, cf)
    r = PF.moe_route(pctx, tp["router"], torch.from_numpy(x).reshape(-1, D))
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.pos.numpy(), pos)
    assert np.array_equal(r.keep.numpy(), keep)
    kept = {(t, s) for t, s in zip(*np.nonzero(keep))}
    assert kept == {(t, s) for t, s in zip(*np.nonzero(r.keep.numpy()))}
    if cf < 1.0 or E == 384:
        assert not keep.all()          # the draw drops pairs
    if zero_rows:
        assert (r.idx[:zero_rows] == torch.arange(k)).all()


def test_make_moe_params_is_the_reference_tree():
    """``n`` stacked layers of the reference's tree and shapes."""
    p, _ = _moe_pair(64, 4, 2, 32, seed=0)
    pi = ParamInit(torch.Generator().manual_seed(0), torch.float32,
                   torch.device("cpu"))
    paths = lambda t: {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                       jax.tree_util.tree_flatten_with_path(t)[0]}
    assert paths(PF.make_moe_params(pi, 3, 64, 4, 32)) == \
        {k: (3,) + v for k, v in paths(p).items()}


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_match_reference(arch):
    FAM.check_forward(arch)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_logits_and_cache_match_reference(arch):
    FAM.check_prefill(arch)


@pytest.mark.parametrize("arch", MOE)
def test_six_decode_steps_match_reference(arch):
    FAM.check_decode(arch)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_reference(arch):
    FAM.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", MOE)
def test_one_train_step_matches_reference(arch):
    FAM.check_train_step(arch)


@pytest.mark.parametrize("arch", MOE)
def test_param_stats_and_counts_match_reference(arch):
    FAM.check_param_stats(arch)
