"""The plain reference against the port's serving path at tiny widths on
the CPU, in float32: the prefill's logits and six decode steps through
the cache, with and without qk-norm; the shared-prefix shortcut against
separate passes; the prefix-cache model's keys against the engine's."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, weights  # noqa: E402
from perfbench import count as C  # noqa: E402
from perfbench.reference.decoder import Decoder, common_prefix  # noqa: E402
from perfbench.reference.prefix_cache import block_keys  # noqa: E402


def tiny(qk_norm: bool, dtype: str = "float32") -> dict:
    return {"hidden_size": 64, "intermediate_size": 96,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
            "rms_norm_eps": 1e-6, "rope_theta": 1e6, "qk_norm": qk_norm,
            "tie_word_embeddings": False, "torch_dtype": dtype}


@pytest.mark.parametrize("qk_norm", [True, False])
def test_reference_matches_prefill_and_decode(qk_norm):
    from repro_torch.models.model import Model
    cfg = tiny(qk_norm)
    w = C.widths(cfg)
    tree = weights.draw(w, 11, "cpu", "float32")
    model = Model(harness.port_arch("tiny", cfg), device="cpu")
    params = weights.program_tree(tree)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, w.vocab, (2, 40))
    toks = torch.as_tensor(prompt)
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, max_len=64)
        got = [logits[:, -1, :w.vocab]]
        seq = prompt
        for _ in range(6):
            nxt = got[-1].argmax(-1)
            seq = np.concatenate([seq, nxt[:, None].numpy()], axis=1)
            logits, cache = model.decode_step(params, cache, nxt[:, None])
            got.append(logits[:, -1, :w.vocab])
    want = Decoder(cfg, tree).logits(
        [seq[0], seq[1]], [range(39, 46), range(39, 46)])
    for row in range(2):
        mine = torch.stack([g[row] for g in got])
        torch.testing.assert_close(mine, want[row], rtol=1e-4, atol=1e-4)


def test_shared_prefix_equals_separate_passes():
    cfg = tiny(True)
    tree = weights.draw(C.widths(cfg), 5, "cpu", "float32")
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 300, 70)
    seqs = [np.concatenate([shared, rng.integers(0, 300, n)])
            for n in (20, 33)]
    want = [range(75, 90), range(69, 103)]
    assert common_prefix(seqs, 69) == 69
    dec = Decoder(cfg, tree)
    together = dec.logits(seqs, want)
    for s, r, t in zip(seqs, want, together):
        torch.testing.assert_close(dec.logits([s], [r])[0], t, rtol=1e-5,
                                   atol=1e-5)


def test_fp8_control_rounds_the_products():
    cfg = tiny(False)
    tree = weights.draw(C.widths(cfg), 2, "cpu", "float32")
    seq = [np.random.default_rng(2).integers(0, 300, 50)]
    f32 = Decoder(cfg, tree).logits(seq, [range(40, 50)])[0]
    low = Decoder(cfg, tree, "fp8").logits(seq, [range(40, 50)])[0]
    diff = (f32 - low).abs().max().item()
    assert 1e-3 < diff < 1.0


def test_block_keys_are_the_engines():
    from repro_torch.serving.engine import _block_hashes
    rng = np.random.default_rng(3)
    for n in (0, 63, 64, 200, 1536):
        p = rng.integers(0, 151936, n).astype(np.int32)
        assert block_keys(p) == [int(h) for h in _block_hashes(p)]
