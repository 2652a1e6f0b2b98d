"""The port's attention kernels' plain versions (the CPU path of
``flash_attention`` and ``paged_attention``) held against the JAX package's
oracles and, for paged attention, its Pallas kernel in interpret mode.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
those of tests/test_kernels.py: 2e-5 in float32 (summation order), 2e-2 in
bfloat16 (outputs rounded to bf16).  The Pallas flash kernel does not run
on the installed jax (ROADMAP C), so flash is held to
``flash_attention_ref`` only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.paged_attention.kernel import paged_attention_fwd
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 paged_attention, paged_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _pair(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol(name), rtol=tol(name))


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,dt", [
    # the shapes of tests/test_kernels.py
    (2, 4, 2, 256, 256, 64, True, "float32"),
    (1, 8, 8, 512, 512, 128, True, "bfloat16"),
    (2, 6, 2, 256, 512, 64, False, "float32"),
    (1, 2, 1, 128, 128, 128, True, "bfloat16"),
    (3, 3, 3, 128, 256, 64, False, "bfloat16"),
    # ragged lengths the TPU kernel's tiling refuses
    (1, 4, 2, 1, 1, 64, True, "float32"),
    (2, 4, 1, 65, 65, 16, True, "float32"),
    (1, 8, 2, 300, 300, 128, True, "float32"),
    (1, 4, 2, 65, 65, 64, True, "bfloat16"),
    (1, 4, 1, 100, 37, 32, False, "float32"),
    # bottom-right causal mask, both ways round (rows with no visible key
    # average all keys, as the reference's softmax does)
    (1, 4, 2, 37, 100, 32, True, "float32"),
    (1, 4, 2, 70, 30, 32, True, "float32"),
    # the other dense configs' groups: smollm-360m (hd 64, G 3) and
    # mistral-large-123b (G 12)
    (1, 15, 5, 130, 130, 64, True, "bfloat16"),
    (1, 24, 2, 70, 70, 128, True, "float32"),
])
def test_flash_plain_matches_reference(B, H, KV, Sq, Skv, hd, causal, dt):
    rng = np.random.default_rng(B * 7 + Sq + Skv)
    q = rng.standard_normal((B, H, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, Skv, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, Skv, hd), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dt) for x in (q, k, v))
    want = flash_attention_ref(qj, kj, vj, causal=causal)
    got = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dt)


def test_flash_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 33, 16),
                                             dtype=np.float32))
    k = q[:, ::2].contiguous()
    before = flash_attention.launches
    out = flash_attention(q, k, k, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, k, causal=True))
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :3], q[:, :3])        # 4 heads over 3
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :0], k[:, :, :0])  # no keys


# ---------------------------------------------------------- paged attention
PAGED_SHAPES = [
    # the shapes of tests/test_kernels.py
    (4, 128, 2, 2, 4, 64, 300, "float32"),
    (8, 256, 1, 8, 8, 128, 2000, "bfloat16"),
    (2, 128, 3, 1, 2, 64, 17, "float32"),
    (16, 128, 1, 4, 8, 128, 2048, "bfloat16"),
    # page edges and the GQA groups of the serving path
    (2, 64, 2, 1, 4, 16, 1, "float32"),
    (2, 64, 2, 1, 4, 16, 63, "float32"),
    (2, 64, 2, 1, 4, 16, 64, "float32"),
    (2, 64, 2, 1, 4, 16, 65, "bfloat16"),
    (2, 64, 2, 2, 8, 32, 128, "float32"),
    # the other dense configs' groups: smollm-360m (hd 64, G 3),
    # mistral-large-123b (G 12) and the kernel's largest group, 16
    (2, 64, 2, 5, 15, 64, 100, "bfloat16"),
    (2, 64, 1, 8, 96, 128, 70, "float32"),
    (2, 64, 2, 1, 16, 64, 65, "float32"),
]


def _paged_inputs(nb, tb, B, KV, H, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd), dtype=np.float32),
            rng.standard_normal((nb, tb, B, KV, hd), dtype=np.float32),
            rng.standard_normal((nb, tb, B, KV, hd), dtype=np.float32))


@pytest.mark.parametrize("nb,tb,B,KV,H,hd,vl,dt", PAGED_SHAPES)
def test_paged_plain_matches_reference_and_pallas(nb, tb, B, KV, H, hd, vl,
                                                   dt):
    q, kc, vc = _paged_inputs(nb, tb, B, KV, H, hd, nb * 31 + B + vl)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dt) for x in (q, kc, vc))
    got = paged_attention_plain(qt, kt, vt, vl)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, paged_attention_ref(qj, kj, vj, jnp.array(vl)), dt)
    _close(got, paged_attention_fwd(qj, kj, vj, jnp.array(vl),
                                    interpret=True), dt)


def test_paged_plain_masks_tail():
    """Garbage beyond valid_len must not affect the output."""
    q, kc, vc = (torch.from_numpy(x)
                 for x in _paged_inputs(4, 64, 1, 2, 2, 64, 5))
    out1 = paged_attention_plain(q, kc, vc, 100)
    kc[2:] = 999.0
    vc[2:] = -999.0
    out2 = paged_attention_plain(q, kc, vc, 100)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_paged_wrapper_takes_plain_version_on_cpu():
    q, kc, vc = (torch.from_numpy(x)
                 for x in _paged_inputs(2, 64, 2, 1, 4, 16, 9))
    before = paged_attention.launches
    out = paged_attention(q, kc, vc, 70)
    assert paged_attention.launches == before
    assert torch.equal(out, paged_attention_plain(q, kc, vc, 70))
    with pytest.raises(ValueError):
        paged_attention(q, kc, vc, 0)                  # nothing to attend
    with pytest.raises(ValueError):
        paged_attention(q, kc[..., :8], vc[..., :8], 5)  # head_dim differs
    with pytest.raises(TypeError):
        paged_attention(q.double(), kc, vc, 5)


@pytest.mark.parametrize("vl", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_device_length_equals_host_int(vl, dt):
    """A one-element int32 ``valid_len`` (the length a captured decode
    step reads on the device) gives the host int's output bit for bit on
    the plain path, at the split edges (64 positions a split) and at all
    nb * tb = 128 positions; a length of another dtype, shape or device
    raises."""
    q, kc, vc = (_pair(x, dt)[1]
                 for x in _paged_inputs(2, 64, 2, 2, 8, 16, vl))
    before = paged_attention.launches
    got = paged_attention(q, kc, vc, torch.tensor([vl], dtype=torch.int32),
                          count_len=vl)
    assert paged_attention.launches == before
    assert torch.equal(got, paged_attention(q, kc, vc, vl))
    for bad in (torch.tensor([vl]), torch.tensor([vl, vl], dtype=torch.int32),
                torch.tensor([vl], dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="device-held valid_len"):
            paged_attention(q, kc, vc, bad)


@pytest.mark.parametrize("vl", [0, -1])
def test_paged_wrapper_raises_below_one_valid_len(vl):
    """A deliberate difference (ROADMAP C): with no position to attend the
    port's wrapper raises on the CPU path (launching nothing), where the
    reference's oracle leaves every score at -1e30 and so averages every
    position's value."""
    q, kc, vc = _paged_inputs(2, 64, 2, 1, 4, 16, 5)
    before = paged_attention.launches
    with pytest.raises(ValueError, match="valid_len"):
        paged_attention(*(torch.from_numpy(x) for x in (q, kc, vc)), vl)
    assert paged_attention.launches == before
    ref = paged_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), vl)
    mean = vc.reshape(-1, 2, 1, 16).mean(axis=0)          # (B, KV, hd)
    np.testing.assert_allclose(np.asarray(ref),
                               np.repeat(mean, 4, axis=1), atol=2e-5)
