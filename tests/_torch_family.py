"""Shared parity checks of the port's model families against the JAX
package, at reduced size in float32 (``reduced(cfg)``), used by
tests/test_torch_moe.py, tests/test_torch_ssm.py and
tests/test_torch_encdec.py.

The port runs the JAX model's own parameters (``params_from_jax``).  The
JAX model runs with ``use_kernels=False``, as in tests/test_torch_models.py:
its flash kernel does not run on the installed jax (ROADMAP C).  Each check
feeds both packages the same numpy-seeded inputs (tokens, and frames for
an encoder-decoder) and states its bound:

* logits and caches: ``2e-5 + 2e-5 x |ref|`` (``F32``, the bound of
  tests/test_kernels.py), or the bound a family passes in, with a bound
  of its own for the attention pages (the caches' k and v) where it
  passes one;
* a loss: 2e-5 relative; gradients and a step's new parameters and
  optimizer state: ``1e-4 x max|ref| + 1e-6`` a leaf (tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as RC
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.models.registry import param_stats as ref_param_stats
from repro.optim import OptConfig as RefOptConfig, Optimizer as RefOpt
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import base as PC
from repro_torch.kernels import KERNELS
from repro_torch.models import build, param_stats, params_from_jax
from repro_torch.optim import (OptConfig, Optimizer, opt_state_from_jax,
                               tree_leaves)
from repro_torch.train import make_train_step
from repro_torch.train.trainer import _value_and_grad

F32 = 2e-5
LOSS = 2e-5               # a loss, relative
B, S = 2, 40              # the prompt: S is not a multiple of the chunk (16)

_PAIRS = {}
_JIT = {}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def pair(arch):
    """(reference model, its f32 parameters, port model, the same
    parameters as the port's tensors) at the reduced size of ``arch``."""
    if arch not in _PAIRS:
        m = ref_build(RC.reduced(RC.get(arch)),
                      make_host_mesh((1, 1), ("data", "model")),
                      use_kernels=False)
        params = m.init(jax.random.key(0))
        port = build(PC.reduced(PC.get(arch)), device="cpu")
        _PAIRS[arch] = (m, params, port,
                        params_from_jax(np_tree(params), device="cpu"))
        _JIT[arch] = (jax.jit(m.prefill, static_argnames="max_len"),
                      jax.jit(m.decode_step))
    return _PAIRS[arch]


def ref_serve(arch):
    """The reference model's ``prefill`` and ``decode_step``, jitted."""
    pair(arch)
    return _JIT[arch]


def inputs(cfg, seed=1, batch=B, seq=S):
    """Tokens (batch, seq) and, for an encoder-decoder, frames (batch,
    enc_seq, d_model) from ``seed``, for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    frames = None
    if cfg.enc_dec:
        frames = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)) \
            .astype(np.float32)
    ref = (jnp.asarray(toks), None if frames is None else jnp.asarray(frames))
    port = (torch.from_numpy(toks).long(),
            None if frames is None else torch.from_numpy(frames))
    return toks, ref, port


def close(got, want, tol=F32, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def launches():
    return {k.__name__: k.launches for k in KERNELS}


def cache_leaves(cache):
    """(name, array) of a cache's layer states and cross K/V, in order."""
    out = []
    for i, c in enumerate(cache["layers"]):
        names = getattr(c, "_fields", ("k", "v"))
        out += [(f"layers/{i}/{n}", x) for n, x in zip(names, c)]
    for i, c in enumerate(cache.get("cross") or []):
        if c is not None:
            out += [(f"cross/{i}/{n}", x) for n, x in zip("kv", c)]
    return out


def assert_caches_close(ct, cj, tol, page_tol=None):
    """Every leaf within ``tol``; the attention pages (k and v) within
    ``page_tol`` where one is given."""
    a, b = cache_leaves(ct), cache_leaves(cj)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert tuple(x.shape) == y.shape and \
            x.dtype == getattr(torch, str(y.dtype)), name
        page = name.rsplit("/", 1)[-1] in ("k", "v")
        close(x, y, page_tol if page and page_tol else tol, name)
    assert int(ct["length"]) == int(cj["length"])


# ------------------------------------------------------------ the checks
def check_forward(arch, tol=F32):
    m, params, port, tp = pair(arch)
    _, (tj, fj), (tt, ft) = inputs(m.cfg)
    before = launches()
    got = port.forward(tp, tt, ft)
    assert launches() == before
    assert tuple(got.shape) == (B, S, m.vocab_p)
    close(got, jax.jit(m.forward)(params, tj, fj), tol, "forward logits")


def check_prefill(arch, tol=F32, page_tol=None):
    m, params, port, tp = pair(arch)
    _, (tj, fj), (tt, ft) = inputs(m.cfg, seed=2)
    lj, cj = ref_serve(arch)[0](params, tj, frames=fj, max_len=128)
    lt, ct = port.prefill(tp, tt, frames=ft, max_len=128)
    close(lt, lj, tol, "prefill logits")
    assert ct["length"] == S
    assert_caches_close(ct, cj, tol, page_tol)


def check_decode(arch, tol=F32, steps=6, page_tol=None):
    """``steps`` greedy decode steps after a prefill, the reference's
    tokens fed to both; the port's greedy tokens must equal them."""
    m, params, port, tp = pair(arch)
    toks, (tj, fj), (tt, ft) = inputs(m.cfg, seed=3)
    prefill, decode = ref_serve(arch)
    _, cj = prefill(params, tj, frames=fj, max_len=128)
    _, ct = port.prefill(tp, tt, frames=ft, max_len=128)
    tok = toks[:, -1:]
    for i in range(steps):
        lj, cj = decode(params, cj, jnp.asarray(tok))
        lt, ct = port.decode_step(tp, ct, torch.from_numpy(tok).long())
        close(lt, lj, tol, f"decode step {i}")
        tok = np.asarray(lj[:, -1]).argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy(), tok[:, 0])
    assert ct["length"] == S + steps
    assert_caches_close(ct, cj, tol, page_tol)


def _batch(cfg, seed=4):
    toks, (tj, fj), (tt, ft) = inputs(cfg, seed=seed)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    jb = {"tokens": tj, "labels": jnp.asarray(labels)}
    tb = {"tokens": tt, "labels": torch.from_numpy(labels).long()}
    if fj is not None:
        jb["frames"], tb["frames"] = fj, ft
    return jb, tb


def assert_tree_close(port, ref, rel=1e-4, abs_=1e-6):
    ref_leaves, port_leaves = jax.tree.leaves(ref), tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(a).max() + abs_


def check_loss_and_grads(arch):
    """``Model.loss`` and its autograd gradients (per-superblock recompute
    on) against the reference's ``jax.value_and_grad``; no kernel
    launches on the training path."""
    m, params, port, tp = pair(arch)
    jb, tb = _batch(m.cfg)
    loss_r, grads_r = jax.jit(jax.value_and_grad(m.loss))(params, jb)
    before = launches()
    loss_p, grads_p = _value_and_grad(port, tp, tb)
    assert launches() == before
    assert abs(float(loss_p) - float(loss_r)) <= LOSS * abs(float(loss_r))
    assert_tree_close(grads_p, grads_r)


def check_train_step(arch):
    m, params, port, tp = pair(arch)
    ropt, popt = RefOpt(RefOptConfig(lr=1e-3)), Optimizer(OptConfig(lr=1e-3))
    rstate = {"params": params, "opt": ropt.init(params)}
    pstate = {"params": tp, "opt": opt_state_from_jax(
        np_tree(rstate["opt"]), device="cpu")}
    jb, tb = _batch(m.cfg, seed=5)
    rs, rmet = jax.jit(ref_make_train_step(m, ropt))(rstate, jb)
    ps, pmet = make_train_step(port, popt)(pstate, tb)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(pmet[k]) - float(rmet[k])) <= \
            LOSS * abs(float(rmet[k])), k
    assert_tree_close(ps["params"], rs["params"])
    assert_tree_close(ps["opt"], rs["opt"])


def check_param_stats(arch):
    """``param_stats`` of the full and the reduced model; the reduced
    reference tree carried by ``params_from_jax`` bit for bit; and the
    port's own init: the reference's tree (leaf names and shapes)."""
    for cfg_p, cfg_r in ((PC.get(arch), RC.get(arch)),
                         (PC.reduced(PC.get(arch)),
                          RC.reduced(RC.get(arch)))):
        mesh = make_host_mesh((1, 1), ("data", "model"))
        assert param_stats(build(cfg_p, device="cpu")) == \
            ref_param_stats(ref_build(cfg_r, mesh))
        assert cfg_p.n_params() == cfg_r.n_params()
        assert cfg_p.n_active_params() == cfg_r.n_active_params()
    m, params, port, tp = pair(arch)
    names = lambda t: [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    for a, b in zip(jax.tree.leaves(params), tree_leaves(tp)):
        assert np.array_equal(np.asarray(a), b.numpy())   # bit for bit
    own = jax.tree.map(lambda t: np.zeros(tuple(t.shape)), port.init(seed=1),
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert names(own) == names(params)



# ------------------------------------------------------------ the readings
def _used(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


def readings(arch, steps=6):
    """The largest difference between the packages on the inputs of
    ``check_forward``, ``check_prefill`` and ``check_decode``, in units of
    the f32 bound: {what: reading}, a cache leaf under its name."""
    m, params, port, tp = pair(arch)
    out = {}
    _, (tj, fj), (tt, ft) = inputs(m.cfg)
    out["forward logits"] = _used(port.forward(tp, tt, ft),
                                  jax.jit(m.forward)(params, tj, fj))
    prefill, decode = ref_serve(arch)
    _, (tj, fj), (tt, ft) = inputs(m.cfg, seed=2)
    lj, cj = prefill(params, tj, frames=fj, max_len=128)
    lt, ct = port.prefill(tp, tt, frames=ft, max_len=128)
    out["prefill logits"] = _used(lt, lj)
    for (name, x), (_, y) in zip(cache_leaves(ct), cache_leaves(cj)):
        out[f"prefill {name}"] = _used(x, y)
    toks, (tj, fj), (tt, ft) = inputs(m.cfg, seed=3)
    _, cj = prefill(params, tj, frames=fj, max_len=128)
    _, ct = port.prefill(tp, tt, frames=ft, max_len=128)
    tok, worst = toks[:, -1:], 0.0
    for _ in range(steps):
        lj, cj = decode(params, cj, jnp.asarray(tok))
        lt, ct = port.decode_step(tp, ct, torch.from_numpy(tok).long())
        worst = max(worst, _used(lt, lj))
        tok = np.asarray(lj[:, -1]).argmax(-1)[:, None].astype(np.int32)
    out["decode logits"] = worst
    for (name, x), (_, y) in zip(cache_leaves(ct), cache_leaves(cj)):
        out[f"decode {name}"] = _used(x, y)
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_torch_family.py ARCH
    import sys
    for what, used in readings(sys.argv[1]).items():
        print(f"{what}: {used:.3f} of {F32} + {F32} x |ref|")
