"""The reduced configs' FLOP counts on both packages, shared by
tests/test_torch_launch_flops.py and tests/test_torch_launch_grad.py: the
port's ``repro_torch.launch.roofline.count`` on the CPU against the JAX
package's ``repro.launch.hlo_analysis.analyze`` of the compiled step, at
B 2, S 64, in f32, the reference built with ``use_kernels=False`` and the
port running its converted weights, each hand-written kernel counted as
its plain version (``plain_kernels``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as RC
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro_torch.configs import base as PC
from repro_torch.kernels import boundary
from repro_torch.launch import roofline as R
from repro_torch.models import build, params_from_jax
from repro_torch.train.trainer import _value_and_grad

B, S = 2, 64


@contextlib.contextmanager
def plain_kernels():
    """Counts in which each hand-written kernel is its plain version, op
    by op, as the reference built with ``use_kernels=False`` is: the
    wrappers' hand-off to the counter (``kernels.boundary.plain``) runs
    the plain version and reports nothing."""
    saved = boundary.plain
    boundary.plain = lambda name, fn, flops, nbytes: fn()
    try:
        yield
    finally:
        boundary.plain = saved

_PAIRS = {}


def pair(arch):
    """(reference model, its params, reference inputs, port model, port
    params, port inputs) at the reduced size, from one seed."""
    if arch not in _PAIRS:
        m = ref_build(RC.reduced(RC.get(arch)),
                      make_host_mesh((1, 1), ("data", "model")),
                      use_kernels=False)
        params = m.init(jax.random.key(0))
        cfg = m.cfg
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        frames = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                  .astype(np.float32) if cfg.enc_dec else None)
        port = build(PC.reduced(PC.get(arch)), device="cpu")
        pp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        _PAIRS[arch] = (
            m, params, (jnp.asarray(toks),
                        None if frames is None else jnp.asarray(frames)),
            port, pp, (torch.from_numpy(toks).long(),
                       None if frames is None else torch.from_numpy(frames)))
    return _PAIRS[arch]


def hlo_flops(f, *args) -> float:
    return analyze(jax.jit(f).lower(*args).compile().as_text()).flops


def counts(arch, step):
    """(reference FLOPs, port FLOPs) of ``step`` of the reduced ``arch``."""
    m, params, (jt, jf), port, pp, (tt, tf) = pair(arch)
    if step == "forward":
        return (hlo_flops(lambda p, t, f: m.forward(p, t, f), params, jt, jf),
                no_grad_count(port.forward, pp, tt, tf))
    if step == "prefill":
        return (hlo_flops(lambda p, t, f: m.prefill(p, t, f), params, jt, jf),
                no_grad_count(port.prefill, pp, tt, tf))
    if step == "decode":
        _, cache = jax.jit(lambda p, t, f: m.prefill(p, t, f))(params, jt, jf)
        with torch.no_grad():
            _, pc = port.prefill(pp, tt, tf)
        return (hlo_flops(lambda p, c, t: m.decode_step(p, c, t), params,
                           cache, jt[:, -1:]),
                no_grad_count(port.decode_step, pp, pc, tt[:, -1:]))
    batch, pb = {"tokens": jt, "labels": jt}, {"tokens": tt, "labels": tt}
    if jf is not None:
        batch["frames"], pb["frames"] = jf, tf
    return (hlo_flops(lambda p, b: jax.value_and_grad(m.loss)(p, b), params,
                       batch),
            plain_count(_value_and_grad, port, pp, pb))


def plain_count(fn, *args) -> float:
    with plain_kernels():
        return R.count(fn, *args).flops


def no_grad_count(fn, *args) -> float:
    with torch.no_grad():
        return plain_count(fn, *args)
