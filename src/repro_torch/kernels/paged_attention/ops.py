"""One-token decode attention over the page-major KV cache: the CUDA
kernel's wrapper and its plain torch version.

``paged_attention(q, kc, vc, valid_len)`` takes q (B, H, hd) and the FUSEE
block pool kc, vc (nb, tb, B, KV, hd), all bfloat16 or all float32, and a
host int ``valid_len`` (1 <= valid_len; positions >= valid_len are masked),
and returns (B, H, hd) in q's dtype.  Query head h reads KV head
h // (H / KV).  The tensors' device decides the path: CPU tensors take
``paged_attention_plain``, and so do ``meta`` tensors, whose run only
propagates shapes (``launch.roofline.count``, which counts the call as
the kernel's ``work``); CUDA tensors launch
``csrc/paged_attention.cu`` (replacing the JAX package's
``kernels/paged_attention/kernel.py::paged_attention_fwd``) or raise; any
other device raises.
The CUDA path splits the valid positions into chunks of ``SPLIT_CHUNK``
(``split_plan``): one CTA per (split, kv head, batch row) writes its
online-softmax partial (m, l, o) in f32 to scratch allocated here, and a
combine kernel in the same call sums the splits.  Every call that launches
adds one to ``paged_attention.launches``.

``valid_len`` may also be a one-element int32 tensor on q's device (the
device-length entry), which the kernels read when they run, so that a CUDA
graph captures the call once and replays it at every length
(``Model.decode_step``): the grid and the scratch are sized for all
nb * tb positions, the splits that start at or past the length return at
once, and the combine sums the others.  ``count_len`` is then the length
where the call is counted (``boundary.plain``: a ``meta`` tensor holds
none).  A replayed graph adds the calls it holds to ``launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import boundary, build

__all__ = ["paged_attention", "paged_attention_plain", "split_plan"]

HEAD_DIMS = (16, 64, 128)   # instantiated: the reduced configs, smollm,
                            # and the other dense configs
MAX_GROUP = 16                      # query heads per kv head in the kernel
NEG_INF = -1e30                     # masked score, as in the reference
SPLIT_CHUNK = 64                    # positions per split: 4 warps x 2 tiles


def split_plan(valid_len: int, chunk: int = SPLIT_CHUNK) -> tuple:
    """(splits, chunk): split s covers cache positions [s * chunk,
    min((s + 1) * chunk, valid_len)), so no split starts at or past
    ``valid_len`` and every split has a finite row max."""
    return -(-int(valid_len) // chunk), chunk


def paged_attention_plain(q: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, valid_len) -> torch.Tensor:
    """Dense masked attention in f32 over every cache position (the
    reference's algorithm; the CPU path and the kernel's oracle);
    ``valid_len`` a host int or a one-element tensor on q's device."""
    nb, tb, B, KV, hd = kc.shape
    H = q.shape[1]
    G = H // KV
    k = kc.float().permute(2, 3, 0, 1, 4).reshape(B, KV, nb * tb, hd)
    v = vc.float().permute(2, 3, 0, 1, 4).reshape(B, KV, nb * tb, hd)
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k) * hd ** -0.5
    mask = torch.arange(nb * tb, device=q.device) < valid_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v)
    return o.reshape(B, H, hd).to(q.dtype)


def work(q, kc, valid_len: int) -> tuple:
    """(FLOPs, bytes) of the kernel on these inputs: two products of 2 *
    hd FLOPs for each valid position and query head; q read, the valid
    positions of the pages read and the output written, each once."""
    nb, tb, B, KV, hd = kc.shape
    H, n = q.shape[1], min(int(valid_len), nb * tb)
    nbytes = q.element_size() * (2 * B * H * hd + 2 * B * KV * n * hd)
    return 4 * B * H * hd * n, nbytes


def _check_inputs(q, kc, vc, valid_len):
    if q.dim() != 3 or kc.dim() != 5 or vc.shape != kc.shape:
        raise ValueError(f"paged_attention: q must be (B, H, hd) and kc, vc "
                         f"(nb, tb, B, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    nb, tb, B, KV, hd = kc.shape
    if q.shape[0] != B or q.shape[2] != hd:
        raise ValueError(f"paged_attention: kc {tuple(kc.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or q.shape[1] % KV:
        raise ValueError(f"paged_attention: {q.shape[1]} query heads do not "
                         f"group over {KV} kv heads")
    if isinstance(valid_len, torch.Tensor):
        if valid_len.dtype != torch.int32 or valid_len.numel() != 1 or \
                valid_len.device != q.device:
            raise ValueError(f"paged_attention: a device-held valid_len is "
                             f"one int32 on {q.device}; got "
                             f"{valid_len.dtype} {tuple(valid_len.shape)} "
                             f"on {valid_len.device}")
    elif not 1 <= int(valid_len):
        raise ValueError(f"paged_attention: valid_len {valid_len} < 1")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"paged_attention: q, kc, vc must all be bfloat16 or "
                        f"all float32, got {q.dtype}, {kc.dtype}, {vc.dtype}")
    if kc.device != q.device or vc.device != q.device:
        raise ValueError(f"paged_attention: q on {q.device}, kc on "
                         f"{kc.device}, vc on {vc.device}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/paged_attention.cu``, built and typed on
    first use."""
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launcher_dev():
    """The device-length entry point, ``paged_attention_launch_dev``."""
    fn = build.load("paged_attention").paged_attention_launch_dev
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    valid_len, count_len=None) -> torch.Tensor:
    """Decode attention on the inputs' device (see module docstring)."""
    _check_inputs(q, kc, vc, valid_len)
    dev_len = isinstance(valid_len, torch.Tensor)
    if q.device.type in ("cpu", "meta"):     # meta: shapes only (a count)
        n = count_len if dev_len and count_len is not None else valid_len
        return boundary.plain(
            "paged_attention",
            lambda: paged_attention_plain(q, kc, vc, valid_len),
            *work(q, kc, n))
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    nb, tb, B, KV, hd = kc.shape
    H = q.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not in {HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention: {H // KV} query heads per kv "
                         f"head, the kernel takes at most {MAX_GROUP}")
    q, kc, vc = q.contiguous(), kc.contiguous(), vc.contiguous()
    if q.data_ptr() % 16 or kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("paged_attention: q, kc and vc must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out                              # nothing to launch
    # a device-held length: the grid and scratch for every position
    n = nb * tb if dev_len else min(int(valid_len), nb * tb)
    splits, chunk = split_plan(n, SPLIT_CHUNK)
    part_o = torch.empty(B * H * splits * hd, dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty(B * H * splits * 2, dtype=torch.float32,
                          device=q.device)
    args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), B, H, KV, hd)
    tail = (hd ** -0.5, int(q.dtype == torch.bfloat16),
            build.stream_ptr(q.device))
    if dev_len:
        err = _launcher_dev()(*args, valid_len.data_ptr(), n, chunk, splits,
                              *tail)
    else:
        err = _launcher()(*args, n, chunk, splits, *tail)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
