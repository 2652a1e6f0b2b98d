"""Forward GQA attention for prefill: the CUDA kernel's wrapper and its
plain torch version.

``flash_attention(q, k, v, causal=True)`` takes q (B, H, Sq, hd) and k, v
(B, KV, Skv, hd), all bfloat16 or all float32, and returns (B, H, Sq, hd)
in q's dtype (on the card in bf16, laid out like q: the kernel reads and
writes strided views such as the model's transposes without a copy).  The
causal mask is bottom-right aligned, as in the JAX package's
``flash_attention_ref``: query i sees key j iff
``j <= i + Skv - Sq`` (prefill has Sq == Skv).  The tensors' device decides
the path: CPU tensors take ``flash_attention_plain``, and so do ``meta``
tensors, whose run only propagates shapes (``launch.roofline.count``,
which counts the call as the kernel's ``work``); CUDA tensors launch
``csrc/flash_attention.cu`` (replacing the JAX package's
``kernels/flash_attention/kernel.py::flash_attention_fwd``) or raise; any
other device raises.
Every kernel launch adds one to ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import boundary, build

__all__ = ["flash_attention", "flash_attention_plain"]

HEAD_DIMS = (16, 64, 128)   # instantiated: the reduced configs, smollm,
                            # and the other dense configs
NEG_INF = -1e30                     # masked score, as in the reference


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Dense attention in f32 over the full score matrix (the reference's
    algorithm; the CPU path and the kernel's oracle)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (query, key) pairs the causal mask leaves visible: the pairs
    the kernel computes (it skips fully masked tiles)."""
    if not causal:
        return Sq * Skv
    off = Skv - Sq
    return Sq * off + Sq * (Sq + 1) // 2 if off >= 0 else Skv * (Skv + 1) // 2


def work(q, k, v, causal: bool) -> tuple:
    """(FLOPs, bytes) of the kernel on these inputs: two products of 2 *
    hd FLOPs for each visible pair and query head; q, k, v read once and
    the output written once."""
    B, H, Sq, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[2], causal)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return 4 * B * H * hd * pairs, nbytes


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {k.shape[1]} kv heads")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Skv == 0)")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be bfloat16 or "
                        f"all float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}"
                         f", v on {v.device}")


def _tma_layout(x: torch.Tensor) -> bool:
    """hd contiguous and every other stride a positive whole number of 16
    bytes (what a TMA tensor map takes)."""
    return x.stride(3) == 1 and all(
        s > 0 and s * x.element_size() % 16 == 0 for s in x.stride()[:3])


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/flash_attention.cu``, built and typed on
    first use."""
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Forward attention on the inputs' device (see module docstring)."""
    _check_inputs(q, k, v)
    if q.device.type in ("cpu", "meta"):     # meta: shapes only (a count)
        return boundary.plain(
            "flash_attention",
            lambda: flash_attention_plain(q, k, v, causal=causal),
            *work(q, k, v, causal))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernel reads any layout TMA can map (hd contiguous, strides
    # of whole 16-byte units): the model's transposed views cost no copy
    q, k, v = (x if bf16 and _tma_layout(x) else x.contiguous()
               for x in (q, k, v))
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)                   # q's layout
    if out.numel() == 0:
        return out                              # nothing to launch
    st = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                    for s in (x.stride(2), x.stride(1),
                                              x.stride(0))))
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, H, KV, Sq, Skv, hd, int(causal),
                      hd ** -0.5, int(bf16), st, build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
