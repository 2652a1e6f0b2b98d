"""The port's counted FLOPs (``repro_torch.launch.roofline.count``) of the
ten reduced configs' forward pass, prefill and decode step held to the
JAX package's HLO count of the compiled step (``tests/_torch_launch.py``:
B 2, S 64, f32, the reference with ``use_kernels=False`` and the port on
its converted weights).  Forward and prefill are equal exactly; decode
differs where the two packages run different products, as its test's
docstring says.  The train step is in tests/test_torch_launch_grad.py.
"""
import pytest

from repro_torch.configs import base as PC

from _torch_launch import B, counts

ARCHS = PC.all_archs()


@pytest.mark.parametrize("step", ["forward", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_flops_equal_reference(arch, step):
    """Every matmul of the forward pass and of prefill (projections, the
    plain attention's full score products, mamba's and the mLSTM's chunk
    products, the sLSTM's recurrent products, the MoE's expert buffers,
    the head) counts 2 * |out| * K, as every ``dot`` of the reference's
    HLO: the totals are equal."""
    ref, port = counts(arch, step)
    assert port == ref > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flops_within_a_tenth_of_a_percent(arch):
    """Within 0.1%.  The reference's decode (``attn_decode_readonly``)
    scores the new token in a dot of its own (``flash_decode_jnp``'s
    ``k_new``) beside the product over every page position; the port
    writes the token's K/V into its page first and its one product covers
    it: 2 * B * H * hd = 256 FLOPs fewer per attention layer (512 for the
    two-layer configs, 256 for jamba's one attention layer, 0 for xlstm),
    about 0.04%."""
    ref, port = counts(arch, "decode")
    cfg = PC.reduced(PC.get(arch))
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers // cfg.attn_every
    assert ref - port == 2 * B * cfg.n_heads * cfg.hd * n_attn
    assert abs(port - ref) <= 1e-3 * ref
