"""The port's encoder-decoder (whisper-medium's backbone: a non-causal
encoder over precomputed frame embeddings, and a decoder with
cross-attention over the encoder's K/V) held against the JAX package's on
the CPU in float32: ``cross_attn`` (serving and training forms),
``cross_attn_kv``, ``Model.encode``, and reduced whisper-medium's forward
with frames, prefill (the cross K/V carried in the cache), 6 decode steps,
loss and gradients, one train step (the batch's ``frames`` through the
port's trainer) and parameter counts (tests/_torch_family.py).

Bounds: 2e-5 + 2e-5 x |ref| (tests/test_kernels.py); gradients and a
step's new state those of tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models.common import ParamBuilder, split_tree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import attention as PA
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer

import _torch_family as FAM

WHISPER = "whisper-medium"


def _cross_params(D=64, H=4, KV=2, hd=16):
    pb = ParamBuilder(jax.random.PRNGKey(3), False, jnp.float32)
    p, _ = split_tree(RA.make_cross_attn_params(pb, D, H, KV, hd))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("Sq,Skv", [(1, 24), (7, 24), (40, 24), (16, 300)])
@pytest.mark.parametrize("train", [False, True])
def test_cross_attn_matches_reference(Sq, Skv, train):
    p, tp = _cross_params()
    rng = np.random.default_rng(Sq + Skv)
    x = rng.standard_normal((2, Sq, 64)).astype(np.float32)
    enc = rng.standard_normal((2, Skv, 64)).astype(np.float32)
    kj, vj = RA.cross_attn_kv(p, jnp.asarray(enc))
    kt, vt = PA.cross_attn_kv(tp, torch.from_numpy(enc))
    FAM.close(kt, kj, what="cross k")
    FAM.close(vt, vj, what="cross v")
    want = RA.cross_attn(p, jnp.asarray(x), kj, vj, q_chunk=16)
    before = FAM.launches()
    got = PA.cross_attn(tp, torch.from_numpy(x), kt, vt, train=train,
                        q_chunk=16)
    assert FAM.launches() == before
    FAM.close(got, want, what="cross_attn")


@pytest.mark.parametrize("train", [False, True])
def test_encode_matches_reference(train):
    m, params, port, tp = FAM.pair(WHISPER)
    frames = np.random.default_rng(7).standard_normal(
        (2, m.cfg.enc_seq, m.cfg.d_model)).astype(np.float32)
    want = m.encode(params, jnp.asarray(frames))
    got = port.encode(tp, torch.from_numpy(frames), train=train)
    assert tuple(got.shape) == (2, m.cfg.enc_seq, m.cfg.d_model)
    FAM.close(got, want, what="encode")
    for (k, v), (kr, vr) in zip(port._cross_kv(tp, got),
                                m._cross_kv(params, want)):
        FAM.close(k, kr, what="cross K of every layer")
        FAM.close(v, vr, what="cross V of every layer")


def test_forward_logits_match_reference():
    FAM.check_forward(WHISPER)


def test_prefill_logits_and_cache_match_reference():
    FAM.check_prefill(WHISPER)


def test_six_decode_steps_match_reference():
    FAM.check_decode(WHISPER)


def test_loss_and_gradients_match_reference():
    FAM.check_loss_and_grads(WHISPER)


def test_one_train_step_matches_reference():
    FAM.check_train_step(WHISPER)


def test_param_stats_and_counts_match_reference():
    FAM.check_param_stats(WHISPER)


class _WithFrames(SyntheticLM):
    """The synthetic token stream with frames (float32) in every batch."""

    def batch_at(self, step):
        b = super().batch_at(step)
        b["frames"] = np.random.default_rng(step).standard_normal(
            (b["tokens"].shape[0], 24, 64)).astype(np.float32)
        return b


def test_trainer_passes_frames_through(tmp_path):
    """The trainer hands a batch's float ``frames`` to ``Model.loss`` as
    the model's dtype, the tokens as int64, with 1 and 2 microbatches."""
    _, _, port, _ = FAM.pair(WHISPER)
    seen = []
    loss = port.loss

    def spy(params, batch):
        seen.append({k: v.dtype for k, v in batch.items()})
        return loss(params, batch)

    port.loss = spy
    try:
        for n_micro in (1, 2):
            tr = Trainer(port, OptConfig(lr=1e-3), TrainConfig(
                n_micro=n_micro, ckpt_every=100,
                ckpt_dir=str(tmp_path / str(n_micro))),
                _WithFrames(DataConfig(vocab=128, seq_len=16,
                                       global_batch=2, seed=1)))
            tr.init_state(0)
            losses = tr.run(2)
            assert len(losses) == 2 and np.isfinite(losses).all()
    finally:
        del port.loss
    assert seen and all(s == {"tokens": torch.int64, "labels": torch.int64,
                              "frames": torch.float32} for s in seen)
