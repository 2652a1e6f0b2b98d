"""Reduced jamba-1.5-large (the hybrid: 1 attention to 7 mamba layers,
MoE on every second) held against the JAX package on the CPU in float32
(tests/_torch_family.py), and through the port's ``ServeEngine`` against
the reference engine.  The mixers alone are in tests/test_torch_ssm.py.

Bounds.  At random init the mamba layers amplify f32 rounding: against
the same model evaluated in float64 (the port's code in double), the last
mamba layer's output is off by 8.5e-4 of its largest value, and both
packages' logits lie up to 3.0 times the f32 bound (2e-5 + 2e-5 x |ref|)
away.  Between the two packages, on these tests' inputs, the largest
readings in units of that f32 bound (``readings`` of
tests/_torch_family.py: ``PYTHONPATH=src:tests python
tests/_torch_family.py jamba-1.5-large-398b``) are: logits 1.87 (forward), 1.74
(prefill), 1.01 (decode); mamba states 2.10; attention pages 6.18 (the
prefill's v of the attention layer, which reads the mamba layers'
output).  So logits and mamba states are held within ``JAMBA``: 1e-4 +
1e-4 x |ref|, and the attention pages within ``JAMBA_PAGES``: 2e-4 + 2e-4
x |ref|.  Gradients and losses keep the bounds of tests/test_torch_train.py.
"""
import numpy as np
import pytest

from repro.serving import (PoolConfig as RefPoolCfg, Request as RefRequest,
                           ServeEngine as RefEngine)
from repro.serving.engine import _block_hashes as ref_block_hashes
from repro_torch.serving import PoolConfig, Request, ServeEngine
from repro_torch.serving.engine import _block_hashes as port_block_hashes

import _torch_family as FAM
from _torch_parity import serve_scenario

JAMBA_ID = "jamba-1.5-large-398b"
JAMBA = 1e-4           # logits and mamba states
JAMBA_PAGES = 2e-4     # the attention layer's k and v pages


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_forward_logits_match_reference(arch):
    FAM.check_forward(arch, JAMBA)


@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_prefill_logits_and_cache_match_reference(arch):
    FAM.check_prefill(arch, JAMBA, page_tol=JAMBA_PAGES)


@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_six_decode_steps_match_reference(arch):
    FAM.check_decode(arch, JAMBA, page_tol=JAMBA_PAGES)


@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_loss_and_gradients_match_reference(arch):
    FAM.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_one_train_step_matches_reference(arch):
    FAM.check_train_step(arch)


@pytest.mark.parametrize("arch", [JAMBA_ID])
def test_param_stats_and_counts_match_reference(arch):
    FAM.check_param_stats(arch)


def test_jamba_engine_matches_reference():
    """tests/test_serving.py's engine scenario (4 requests sharing a
    64-token prefix, max_batch 2) with reduced jamba: equal tokens,
    prefix hits and per-key SEARCH results."""
    m, params, port, tp = FAM.pair(JAMBA_ID)
    _, ref_done, ref_search = serve_scenario(
        RefEngine, RefRequest, RefPoolCfg, ref_block_hashes, m, params)
    eng, done, search = serve_scenario(ServeEngine, Request, PoolConfig,
                                       port_block_hashes, port, tp)
    assert len(done) == 4 and all(len(q.out) == 4 for q in done)
    assert [(q.rid, q.out, q.prefix_hits) for q in done] == \
        [(q.rid, q.out, q.prefix_hits) for q in ref_done]
    assert np.array_equal(search[0], ref_search[0])
    assert np.array_equal(search[1], ref_search[1])
