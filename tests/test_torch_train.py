"""The port's training stack held against the JAX package's on the CPU:
the training forward and loss with their gradients, one optimizer step
and 30 trainer steps from one converted state, microbatch accumulation,
the fault drill and the straggler watchdog, and the synthetic data
pipeline.  The port's twins of the training cases of
``tests/test_system.py``.

Both packages start from the reference's parameters and optimizer state
(``params_from_jax`` / ``opt_state_from_jax``) at reduced size in f32.
Bounds: a loss within 2e-5 relative and each gradient leaf within
1e-4 x max|ref| + 1e-6 after one step; every loss of a 30-step run within
1e-3 relative (summation order in f32, compounded by the updates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RC
from repro.data import DataConfig as RefDataConfig, SyntheticLM as RefData
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.optim import OptConfig as RefOptConfig, Optimizer as RefOpt
from repro.train import (StragglerWatchdog as RefWatchdog,
                         TrainConfig as RefTrainConfig, Trainer as RefTrainer,
                         make_train_step as ref_make_train_step)
from repro_torch.configs import base as PC
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import KERNELS
from repro_torch.models import build, params_from_jax
from repro_torch.optim import (OptConfig, Optimizer, opt_state_from_jax,
                               tree_leaves)
from repro_torch.train import (StragglerWatchdog, TrainConfig, Trainer,
                               make_train_step, pick_microbatches)
from repro_torch.train.trainer import _value_and_grad

DENSE = ["llama3-8b", "smollm-360m", "qwen3-32b", "mistral-large-123b",
         "chameleon-34b"]
LOSS_STEP = 2e-5          # one step: loss, relative
LOSS_RUN = 1e-3           # a 30-step run: every step's loss, relative


def _mesh():
    return make_host_mesh((1, 1), ("data", "model"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, **over):
    rcfg = dataclasses.replace(RC.reduced(RC.get(arch)), **over)
    pcfg = dataclasses.replace(PC.reduced(PC.get(arch)), **over)
    return ref_build(rcfg, _mesh()), build(pcfg, device="cpu")


def _batch(vocab, B=4, S=32, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _assert_tree_close(port, ref, rel=1e-4, abs_=1e-6):
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(a).max() + abs_


# ------------------------------------------------------ forward and loss
@pytest.mark.parametrize("arch", [a for a in DENSE
                                  if a != "mistral-large-123b"])
def test_loss_and_gradients_match_reference(arch):
    """Model.loss and its autograd gradients (per-layer recompute on) equal
    the reference's ``jax.value_and_grad`` from the same parameters; no
    kernel launches on the training path.  (mistral-large-123b's reduced
    twin is reduced llama3-8b's but for rope_theta.)"""
    rm, pm = _models(arch)
    params = rm.init(jax.random.key(0))
    tp = params_from_jax(_np(params), device="cpu")
    jb, tb = _batch(rm.cfg.vocab)
    loss_r, grads_r = jax.jit(jax.value_and_grad(rm.loss))(params, jb)
    before = {k.__name__: k.launches for k in KERNELS}
    loss_p, grads_p = _value_and_grad(pm, tp, tb)
    assert {k.__name__: k.launches for k in KERNELS} == before
    assert abs(float(loss_p) - float(loss_r)) <= LOSS_STEP * abs(
        float(loss_r))
    _assert_tree_close(grads_p, grads_r)
    logits = pm.forward(tp, tb["tokens"])
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(rm.forward)(params, jb["tokens"])), rtol=2e-5,
        atol=2e-5)


def test_remat_block_gives_the_gradients_of_no_remat():
    _, pm = _models("smollm-360m")
    _, pn = _models("smollm-360m", remat="none")
    tp = pm.init(seed=3)
    _, tb = _batch(128, seed=4)
    la, ga = _value_and_grad(pm, tp, tb)
    lb, gb = _value_and_grad(pn, tp, tb)
    assert float(la) == float(lb)
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_masks_padded_columns_and_unlabelled_positions():
    from repro.models.common import softmax_cross_entropy as ref_ce
    from repro_torch.models.common import softmax_cross_entropy
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    labels = rng.integers(0, 200, (2, 5)).astype(np.int32)
    labels[0, 2] = labels[1, 4] = -1
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), 200)
    want = ref_ce(jnp.asarray(logits), jnp.asarray(labels), 200)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    none = -np.ones((2, 5), np.int32)
    assert float(softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(none), 200)) == 0.0


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b"])
def test_one_train_step_matches_reference(arch):
    rm, pm = _models(arch)
    params = rm.init(jax.random.key(0))
    ropt, popt = RefOpt(RefOptConfig(lr=1e-3)), Optimizer(OptConfig(lr=1e-3))
    rstate = {"params": params, "opt": ropt.init(params)}
    pstate = {"params": params_from_jax(_np(params), device="cpu"),
              "opt": opt_state_from_jax(_np(rstate["opt"]), device="cpu")}
    jb, tb = _batch(rm.cfg.vocab, seed=2)
    rs, rmet = jax.jit(ref_make_train_step(rm, ropt))(rstate, jb)
    ps, pmet = make_train_step(pm, popt)(pstate, tb)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(pmet[k]) - float(rmet[k])) <= \
            LOSS_STEP * abs(float(rmet[k])), k
    _assert_tree_close(ps["params"], rs["params"])
    _assert_tree_close(ps["opt"], rs["opt"])
    assert int(ps["opt"]["count"]) == int(rs["opt"]["count"]) == 1


def test_microbatch_accumulation_matches_full_batch():
    """n_micro 4 against n_micro 1 on the port (the reference's test), and
    the port's 4-microbatch step against the reference's."""
    rm, pm = _models("llama3-8b")
    params = rm.init(jax.random.key(0))
    tp = params_from_jax(_np(params), device="cpu")
    ropt, popt = RefOpt(RefOptConfig(lr=1e-3)), Optimizer(OptConfig(lr=1e-3))
    jb, tb = _batch(rm.cfg.vocab, B=4, seed=5)
    st1, m1 = make_train_step(pm, popt, n_micro=1)(
        {"params": tp, "opt": popt.init(tp)}, tb)
    st4, m4 = make_train_step(pm, popt, n_micro=4)(
        {"params": tp, "opt": popt.init(tp)}, tb)
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= \
        LOSS_STEP * abs(float(m1["loss"]))
    for a, b in zip(tree_leaves(st1["params"]), tree_leaves(st4["params"])):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()) \
            + 1e-6
    rs4, rm4 = jax.jit(ref_make_train_step(rm, ropt, n_micro=4))(
        {"params": params, "opt": ropt.init(params)}, jb)
    assert abs(float(m4["loss"]) - float(rm4["loss"])) <= \
        LOSS_STEP * abs(float(rm4["loss"]))
    _assert_tree_close(st4["params"], rs4["params"])


def test_pick_microbatches_on_one_device():
    rm, pm = _models("llama3-8b")
    full_p = build(PC.get("smollm-360m"), device="cpu")
    full_r = ref_build(RC.get("smollm-360m"), _mesh())
    from repro.train import pick_microbatches as ref_pick
    for model_p, model_r in ((pm, rm), (full_p, full_r)):
        for gb, seq in ((8, 1024), (256, 4096), (4, 32), (6, 8192)):
            assert pick_microbatches(model_p, gb, seq) == \
                ref_pick(model_r, gb, seq)


# --------------------------------------------------------------- trainer
_DATA = dict(vocab=128, seq_len=32, global_batch=4, seed=0)
_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)


@pytest.fixture(scope="module")
def ref_curve(tmp_path_factory):
    """The reference's ``_make_trainer`` run (reduced smollm-360m, seq 32,
    batch 4, AdamW lr 3e-3 with 5 warmup steps, a checkpoint every 5
    steps): the fault drill (a crash at step 12 of 16, then a restore),
    continued to step 30.  Returns its initial state as numpy arrays and
    the loss of each of the 30 steps, as last computed (training is
    deterministic, so a step run again after the restore gives the loss
    an uninterrupted run gives)."""
    rm, _ = _models("smollm-360m")
    ref = RefTrainer(rm, RefOptConfig(**_OPT), RefTrainConfig(
        ckpt_every=5, ckpt_dir=str(tmp_path_factory.mktemp("ref"))),
        RefData(RefDataConfig(**_DATA)))
    init = _np(ref.init_state(jax.random.PRNGKey(0)))
    _, recovered = ref.run_with_recovery(16, fail_at=12)
    assert recovered and ref.step == 16
    ref.run(30)
    losses = {h["step"]: h["loss"] for h in ref.history}
    return init, [losses[i] for i in range(30)]


def _port_trainer(tmp_path, init):
    _, pm = _models("smollm-360m")
    port = Trainer(pm, OptConfig(**_OPT), TrainConfig(
        ckpt_every=5, ckpt_dir=str(tmp_path / "port")),
        SyntheticLM(DataConfig(**_DATA)))
    port.state = {"params": params_from_jax(init["params"], device="cpu"),
                  "opt": opt_state_from_jax(init["opt"], device="cpu")}
    return port


def test_training_loss_decreases_as_the_reference(tmp_path, ref_curve):
    init, want = ref_curve
    port = _port_trainer(tmp_path, init)
    got = port.run(30)
    assert len(got) == 30
    np.testing.assert_allclose(got, want, rtol=LOSS_RUN)
    first, last = np.mean(got[:5]), np.mean(got[-5:])
    assert last < first - 0.2, f"no learning: {first:.3f} -> {last:.3f}"
    assert port.ckpt.latest().endswith("step_00000030")
    assert len(port.watchdog.times) == 30


def test_fault_drill_recovers_and_finishes_as_the_reference(tmp_path,
                                                             ref_curve):
    """The port's drill restores step 10's checkpoint (the save in flight
    at the crash lands first) and runs steps 10..15 again, with the
    reference's losses for those steps."""
    init, want = ref_curve
    port = _port_trainer(tmp_path, init)
    got, recovered = port.run_with_recovery(16, fail_at=12)
    assert recovered and port.step == 16
    assert port.ckpt.latest().endswith("step_00000016")
    assert [h["step"] for h in port.history] == \
        list(range(12)) + list(range(10, 16))
    np.testing.assert_allclose(got, want[10:16], rtol=LOSS_RUN)


def test_fault_drill_without_a_checkpoint_starts_over(tmp_path):
    _, pm = _models("smollm-360m")
    port = Trainer(pm, OptConfig(**_OPT), TrainConfig(
        ckpt_every=100, ckpt_dir=str(tmp_path / "port")),
        SyntheticLM(DataConfig(**_DATA)))
    port.init_state(0)
    losses, recovered = port.run_with_recovery(4, fail_at=2)
    assert recovered and port.step == 4 and len(losses) == 4


def test_straggler_watchdog_flags_outliers():
    for W in (StragglerWatchdog, RefWatchdog):
        wd = W(factor=3.0)
        for i in range(20):
            wd.record(i, 0.1)
        wd.record(20, 1.0)
        assert 20 in wd.straggler_steps
        assert wd.summary()["stragglers"] == 1
    assert StragglerWatchdog().summary() == RefWatchdog().summary()


# --------------------------------------------------------------- datasets
@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_data_matches_reference_bit_for_bit(shards):
    cfg = dict(vocab=1000, seq_len=16, global_batch=8, seed=3)
    for shard in range(shards):
        a = SyntheticLM(DataConfig(**cfg), shard_id=shard, num_shards=shards)
        b = RefData(RefDataConfig(**cfg), shard_id=shard, num_shards=shards)
        assert np.array_equal(a.succ, b.succ)
        for step in (0, 7, 1000):
            x, y = a.batch_at(step), b.batch_at(step)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_synthetic_data_deterministic_and_sharded():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=3)
    a = SyntheticLM(cfg).batch_at(7)
    b = SyntheticLM(cfg).batch_at(7)
    assert np.array_equal(a["tokens"], b["tokens"])
    s0 = SyntheticLM(cfg, shard_id=0, num_shards=2).batch_at(7)
    s1 = SyntheticLM(cfg, shard_id=1, num_shards=2).batch_at(7)
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()


def test_prefetch_thread_starts_serves_in_order_and_joins():
    ds = SyntheticLM(DataConfig(vocab=100, seq_len=8, global_batch=2,
                                seed=1, prefetch=2))
    ds.start(first_step=5)
    it = iter(ds)
    try:
        for want in (5, 6, 7):
            step, batch = next(it)
            assert step == want
            assert np.array_equal(batch["tokens"],
                                  ds.batch_at(want)["tokens"])
    finally:
        ds.stop()
    assert not ds._thread.is_alive()

