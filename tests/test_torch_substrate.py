"""The port's optimizer, schedule, clipping, gradient compression and
checkpoints held against the JAX package's on the CPU: the port's twins of
the optimizer and checkpoint cases of ``tests/test_substrate.py``.

An update from equal gradients gives the reference's int8 codes bit for
bit and its f32 values within 1e-6; checkpoints of equal states have equal
manifests (leaf names, shapes, logical dtypes, shard files, CRC32s) and
each package loads the other's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import (CheckpointManager as RefManager,
                        load_checkpoint as ref_load,
                        save_checkpoint as ref_save)
from repro.optim import (OptConfig as RefOptConfig, Optimizer as RefOpt,
                         clip_by_global_norm as ref_clip,
                         global_norm as ref_norm, schedule as ref_schedule)
from repro.optim.compress import _quant as ref_quant
from repro_torch.ckpt import (CheckpointManager, latest, load_checkpoint,
                              save_checkpoint)
from repro_torch.models import params_from_jax
from repro_torch.optim import (Moment, OptConfig, Optimizer,
                               clip_by_global_norm, global_norm,
                               init_error_feedback, opt_state_from_jax,
                               pod_compressed_mean, schedule, tree_leaves)
from repro_torch.optim.compress import _quant


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_leaves(port, ref):
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    port_leaves = [x.numpy() for x in tree_leaves(port)]
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
    return zip(ref_leaves, port_leaves)


# ------------------------------------------------------------- optimizer ---
def test_adamw_matches_reference_math():
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
              grad_clip=1e9, warmup_steps=0, total_steps=10**9,
              min_lr_ratio=1.0)
    opt = Optimizer(OptConfig(**kw))
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    new_p, state, _ = opt.update(g, opt.init(p), p)
    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.01 * np.array([0.1, 0.2, -0.3]) ** 2
    step = (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(),
                               np.array([1.0, -2.0, 3.0]) - 0.1 * step,
                               rtol=1e-5)
    ref = RefOpt(RefOptConfig(**kw))
    rp = {"w": jnp.array([1.0, -2.0, 3.0])}
    want, _, _ = ref.update({"w": jnp.array([0.1, 0.2, -0.3])},
                            ref.init(rp), rp)
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(want["w"]),
                               rtol=0, atol=1e-6)


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (16, 64), "b": (64,), "s": (), "layers": (2, 8, 32)}


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("name", ["adamw", "lion", "sgdm"])
def test_update_from_equal_gradients_matches_reference(name, moments):
    """Three updates of both packages from one state and equal gradients:
    int8 codes bit for bit, f32 values (parameters, moments, scales, lr,
    grad norm) within 1e-6.  Clipping is off (its factor is exactly 1), so
    the moments see equal gradients: a clipped gradient carries the global
    norm's summation order, which differs between the packages by an ulp
    (``test_grad_clip`` holds it within 1e-6)."""
    kw = dict(name=name, moments=moments, lr=1e-2, warmup_steps=2,
              total_steps=20, weight_decay=0.1, grad_clip=1e9)
    ref, opt = RefOpt(RefOptConfig(**kw)), Optimizer(OptConfig(**kw))
    rng = np.random.default_rng(11)
    p_np = _tree(rng, SHAPES)
    rp = {k: jnp.asarray(v) for k, v in p_np.items()}
    rs = ref.init(rp)
    pp = params_from_jax(p_np, device="cpu")
    ps = opt.init(pp)
    for a, b in _pair_leaves(ps, rs):
        assert np.array_equal(a, b)
    for i in range(3):
        g_np = {k: v * 0.3 for k, v in _tree(rng, SHAPES).items()}
        rp, rs, rm = ref.update({k: jnp.asarray(v) for k, v in g_np.items()},
                                rs, rp)
        pp, ps, pm = opt.update(params_from_jax(g_np, device="cpu"), ps, pp)
        for k in ("lr", "grad_norm"):
            assert abs(float(pm[k]) - float(rm[k])) <= 1e-6 * max(
                1.0, abs(float(rm[k])))
        for a, b in _pair_leaves(ps, rs):
            if a.dtype == np.int8 or a.dtype == np.int32:
                assert np.array_equal(a, b)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        for a, b in _pair_leaves(pp, rp):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    if moments == "int8":
        assert ps["m"]["w"].value.dtype == torch.int8
        assert ps["m"]["s"].scale is None          # a 0-d leaf stays f32


def test_opt_state_from_jax_is_bit_identical():
    ref = RefOpt(RefOptConfig(moments="int8"))
    rng = np.random.default_rng(2)
    rp = {k: jnp.asarray(v) for k, v in _tree(rng, SHAPES).items()}
    rs = ref.init(rp)
    _, rs, _ = ref.update({k: jnp.asarray(v) for k, v in
                           _tree(rng, SHAPES).items()}, rs, rp)
    ps = opt_state_from_jax(_np(rs), device="cpu")
    assert isinstance(ps["m"]["w"], Moment) and ps["m"]["s"].scale is None
    for a, b in _pair_leaves(ps, rs):
        assert np.array_equal(a, b)


def test_int8_moments_track_fp32_closely():
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((64, 256))
                               .astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((64, 256))
                               .astype(np.float32)) * 0.01}
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0)
    o32 = Optimizer(OptConfig(moments="fp32", **cfg))
    o8 = Optimizer(OptConfig(moments="int8", **cfg))
    s32, s8 = o32.init(p), o8.init(p)
    p32, p8 = p, p
    for _ in range(10):
        p32, s32, _ = o32.update(g, s32, p32)
        p8, s8, _ = o8.update(g, s8, p8)
    diff = (p32["w"] - p8["w"]).abs()
    disp = (p32["w"] - p["w"]).abs()
    assert float(diff.mean() / disp.mean()) < 0.05
    d32 = (p32["w"] - p["w"]).ravel()
    d8 = (p8["w"] - p["w"]).ravel()
    cos = float(d32 @ d8 / (d32.norm() * d8.norm()))
    assert cos > 0.99, f"update direction diverged: cos={cos:.4f}"
    assert s8["m"]["w"].value.dtype == torch.int8


def test_lion_and_sgdm_step():
    for name in ("lion", "sgdm"):
        opt = Optimizer(OptConfig(name=name, lr=1e-2, warmup_steps=0,
                                  total_steps=10**9, min_lr_ratio=1.0,
                                  weight_decay=0.0))
        p = {"w": torch.ones(4)}
        new_p, _, _ = opt.update({"w": torch.ones(4)}, opt.init(p), p)
        assert float(new_p["w"][0]) < 1.0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        Optimizer(OptConfig(name="adagrad")).init({"w": torch.ones(2)})


def test_schedule_warmup_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_ratio=0.1)
    assert float(schedule(cfg, 0)) == 0.0
    assert abs(float(schedule(cfg, 10)) - 1.0) < 1e-6
    assert abs(float(schedule(cfg, 110)) - 0.1) < 1e-6
    rcfg = RefOptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 37, 60, 109, 110, 500):
        assert abs(float(schedule(cfg, torch.tensor(step, dtype=torch.int32)))
                   - float(ref_schedule(rcfg, jnp.array(step)))) <= 1e-6


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == 20.0
    rng = np.random.default_rng(5)
    tree = {"b": [rng.standard_normal((3, 5)).astype(np.float32)],
            "a": rng.standard_normal(7).astype(np.float32)}
    got, gn = clip_by_global_norm(params_from_jax(tree, device="cpu"), 0.5)
    want, wn = ref_clip(jax.tree.map(jnp.asarray, tree), 0.5)
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    assert abs(float(global_norm(got)) - float(ref_norm(want))) <= 1e-6
    for a, b in _pair_leaves(got, want):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------- pod compression ---
@pytest.mark.parametrize("seed", [0, 1, 17, 404, 1000])
def test_pod_compression_error_feedback_converges(seed):
    """int8-compressed mean with error feedback on one pod: the running sum
    of the merged stream tracks the true sum, and every step's codes and
    merge equal the reference's ``_quant`` of the same input."""
    rng = np.random.default_rng(seed)
    g_true = rng.normal(size=(128,)).astype(np.float32) * 0.01
    err = init_error_feedback({"g": torch.zeros(128)})
    acc_c, acc_t = np.zeros_like(g_true), np.zeros_like(g_true)
    for _ in range(50):
        g = g_true + rng.normal(size=g_true.shape).astype(np.float32) * 1e-3
        x = g + err["g"].numpy()
        merged, err = pod_compressed_mean({"g": torch.from_numpy(g)}, err)
        q, s = ref_quant(jnp.asarray(x))
        deq = np.asarray(q, np.float32) * np.asarray(s)
        assert np.array_equal(merged["g"].numpy(), deq)
        np.testing.assert_array_equal(err["g"].numpy(), x - deq)
        acc_c += merged["g"].numpy()
        acc_t += g
    assert np.abs(acc_c - acc_t).max() / np.abs(acc_t).max() < 0.02


def test_quant_codes_match_reference_on_rows_and_scalars():
    rng = np.random.default_rng(9)
    for x in (rng.standard_normal((6, 33)).astype(np.float32),
              np.float32(-0.75), np.zeros((2, 4), np.float32)):
        q, s = _quant(torch.from_numpy(np.array(x)))
        rq, rs = ref_quant(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(s.numpy(), np.asarray(rs))


# ------------------------------------------------------------ checkpoint ---
def _ref_tree():
    return {"a": jnp.arange(1024, dtype=jnp.float32).reshape(32, 32),
            "nested": {"b": jnp.ones((8,), jnp.bfloat16),
                       "c": jnp.array(7, jnp.int32)}}


def _port_tree():
    return {"a": torch.arange(1024, dtype=torch.float32).reshape(32, 32),
            "nested": {"b": torch.ones(8, dtype=torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_preserves_dtypes(tmp_path):
    t = _port_tree()
    save_checkpoint(str(tmp_path), 3, t)
    loaded, step, _ = load_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(t), tree_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_commit_survives_partial_write(tmp_path):
    t = _port_tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "junk.npy").write_bytes(b"xx")
    _, step, _ = load_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 1


def test_checkpoint_detects_corruption(tmp_path):
    t = _port_tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    target = [f for f in os.listdir(path) if f.startswith("a")][0]
    fp = os.path.join(path, target)
    raw = bytearray(open(fp, "rb").read())
    raw[-8] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        load_checkpoint(str(tmp_path), t, device="cpu")


def test_checkpoint_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _port_tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_00000004"
    assert mgr.saved_steps == [1, 2, 3, 4]
    assert mgr.latest() == latest(str(tmp_path))


def test_checkpoint_manager_snapshots_before_returning(tmp_path):
    """``save_async`` copies the tensors before it returns: writing them
    afterwards does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _port_tree()
    mgr.save_async(1, t)
    t["a"].fill_(-1.0)
    mgr.wait()
    loaded, _, _ = load_checkpoint(str(tmp_path), _port_tree(), device="cpu")
    assert torch.equal(loaded["a"], _port_tree()["a"])


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _train_state(moments):
    """Equal optimizer states of both packages over a tree with a bf16
    leaf big enough to shard, after one update."""
    rng = np.random.default_rng(4)
    p_np = {"big": rng.standard_normal((1100, 512)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((4, 32))
                        .astype(np.float32)}],
            "ln": np.ones(32, np.float32)}
    rp = jax.tree.map(jnp.asarray, p_np)
    rp["big"] = rp["big"].astype(jnp.bfloat16)
    ref = RefOpt(RefOptConfig(moments=moments))
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), rp)
    rp, rs, _ = ref.update(g, ref.init(rp), rp)
    rstate = {"params": rp, "opt": rs}
    pstate = {"params": params_from_jax(_np(rp), device="cpu"),
              "opt": opt_state_from_jax(_np(rs), device="cpu")}
    return rstate, pstate


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_checkpoints_cross_between_packages(tmp_path, moments):
    rstate, pstate = _train_state(moments)
    rpath = ref_save(str(tmp_path / "ref"), 7, rstate, extra={"data_step": 7})
    ppath = save_checkpoint(str(tmp_path / "port"), 7, pstate,
                            extra={"data_step": 7})
    a, b = _manifest(rpath), _manifest(ppath)
    assert a == b
    assert json.dumps(a) == json.dumps(b)             # same key order too
    assert a["leaves"]["params/big"]["dtype"] == "bfloat16"
    assert len(a["leaves"]["params/big"]["shards"]) == 4
    assert sorted(os.listdir(rpath)) == sorted(os.listdir(ppath))
    for f in os.listdir(rpath):
        with open(os.path.join(rpath, f), "rb") as x, \
                open(os.path.join(ppath, f), "rb") as y:
            assert x.read() == y.read(), f
    # each package loads the other's checkpoint
    got, step, extra = load_checkpoint(str(tmp_path / "ref"), pstate,
                                       device="cpu")
    assert (step, extra) == (7, {"data_step": 7})
    for x, y in zip(tree_leaves(got), tree_leaves(pstate)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    want, step, _ = ref_load(str(tmp_path / "port"), rstate)
    assert step == 7
    for x, y in zip(jax.tree.leaves(want), jax.tree.leaves(rstate)):
        assert x.dtype == y.dtype
        assert np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32))


def test_reference_manager_gc_keeps_the_same_steps(tmp_path):
    rmgr, pmgr = RefManager(str(tmp_path / "r"), keep=3), \
        CheckpointManager(str(tmp_path / "p"), keep=3)
    for s in (5, 10, 15, 20, 25):
        rmgr.save_async(s, _ref_tree())
        pmgr.save_async(s, _port_tree())
    rmgr.wait()
    pmgr.wait()
    assert sorted(os.listdir(tmp_path / "r")) == \
        sorted(os.listdir(tmp_path / "p")) == \
        ["step_00000015", "step_00000020", "step_00000025"]


def test_restore_onto_a_device_from_meta_shapes(tmp_path):
    """``load_checkpoint`` needs only the target's structure and dtypes:
    ``meta`` tensors will do, as the trainer's restore passes them."""
    t = _port_tree()
    save_checkpoint(str(tmp_path), 1, t)
    like = {"a": torch.empty(32, 32, device="meta"),
            "nested": {"b": torch.empty(8, dtype=torch.bfloat16,
                                        device="meta"),
                       "c": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    loaded, _, _ = load_checkpoint(str(tmp_path), like, device="cpu")
    for a, b in zip(tree_leaves(t), tree_leaves(loaded)):
        assert b.device.type == "cpu" and torch.equal(a, b)
