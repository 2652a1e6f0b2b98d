"""A counted roofline for the port's eager steps, and its measurement on
the card.

Counterpart of the JAX package's ``launch/hlo_analysis.py``, which parses
compiled HLO text.  Eager PyTorch has no HLO: ``count`` runs the step under
a ``TorchDispatchMode`` and counts the aten ops it dispatches, on real
tensors or on ``meta`` tensors (shapes only, nothing stored or computed).
Each rule of the reference has an eager twin:

* FLOPs: every ``dot`` is 2 * |out| * contracted size.  Here every matmul
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the convolutions) counts by
  ``torch.utils.flop_counter``'s registered formulas, the same rule;
  elementwise arithmetic counts nothing in either.
* HBM bytes: operand bytes + output bytes of every kernel (a top-level op
  of a scheduled computation, a fusion counted at its boundary).  Here
  every aten op that is a kernel counts its tensor operands and outputs.
  Views and metadata ops (``view``, ``slice``, ``transpose``,
  ``_unsafe_view``, ``detach``, allocations) count nothing, as ``bitcast``,
  ``get-tuple-element`` and ``tuple`` count nothing there.  A broadcast
  operand counts its distinct elements (stride-0 dims dropped).  Three
  rules follow what the kernel touches, as the reference's slice
  discounts do: a fill or copy does not read its destination; a gather
  (``index``, ``embedding``, ``index_select``, ``gather``) reads as many
  source bytes as it writes; a scatter (``index_put_``, ``index_add_``,
  ``scatter_add_``) touches its destination only at its values' size.
* The panel discount: the reference drops from ``hbm_bytes`` the score
  panels that a Pallas kernel keeps on chip (``panel_hints``) and keeps
  them in ``hbm_bytes_raw``.  Here a hand-written kernel's wrapper hands
  its plain version to the counter (``kernels.boundary``), which counts
  the kernel as one op at its own boundary: the FLOPs it does (the visible
  pairs of a causal mask, not the full score matrix) and the bytes it
  moves (each input read once, the output written once).  The plain
  version's ops (its f32 copies, its score panels) count only in
  ``hbm_bytes_raw``.
* Trip counts: a ``while`` body's costs times the trip count read from its
  condition.  Here a sequential loop of equal bodies goes through
  ``models.common.sampled``: on ``meta`` one body runs and its ops count
  times the trip count.  On the CPU and the card every body runs.
* Collectives: the ring model's wire bytes.  One card has none: the
  collective fields stay 0 and keep their keys.

Left out with the HLO: the text parser, XLA's ``cost_analysis`` /
``memory_analysis``, and the CPU backend's bf16 float-normalization
heuristics (``_bf16_origin``, ``_is_normalization_fusion``): eager ops
run in their own dtypes.

``measure`` times a step on the card and sets it beside its bound.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import boundary
from ..models import common

aten = torch.ops.aten

# ops that are neither views nor kernels: allocations and metadata
_FREE = frozenset((
    aten._unsafe_view, aten.empty, aten.empty_like, aten.empty_strided,
    aten.new_empty, aten.new_empty_strided, aten.lift_fresh, aten.detach,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten.resize_, aten.set_, aten.alias))
# write their output without reading their first operand
_WRITE_ONLY = frozenset((
    aten.copy_, aten.fill_, aten.zero_, aten.zeros_like, aten.ones_like,
    aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full))
# read as many bytes of their first operand as they write
_GATHERS = frozenset((aten.index, aten.embedding, aten.index_select,
                      aten.gather))
# touch their first operand only at the size of their last tensor operand
_SCATTERS = frozenset((aten.index_put_, aten.index_put,
                       aten._index_put_impl_, aten.index_add_,
                       aten.index_add, aten.scatter_add_, aten.scatter_add,
                       aten.index_copy_))


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0          # hand-written kernels at their boundary
    hbm_bytes_raw: float = 0.0      # their plain versions, op by op
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    n_collectives: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    coll_by_shape: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    hbm_by_shape: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    def scaled(self, k: float) -> "Costs":
        c = Costs(self.flops * k, self.hbm_bytes * k, self.hbm_bytes_raw * k,
                  self.coll_bytes * k)
        for kk, v in self.coll_by_kind.items():
            c.coll_by_kind[kk] = v * k
        for kk, v in self.n_collectives.items():
            c.n_collectives[kk] = int(v * k)
        for kk, v in self.coll_by_shape.items():
            c.coll_by_shape[kk] = v * k
        for kk, v in self.hbm_by_shape.items():
            c.hbm_by_shape[kk] = v * k
        return c

    def add(self, o: "Costs"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.hbm_bytes_raw += o.hbm_bytes_raw
        self.coll_bytes += o.coll_bytes
        for kk, v in o.coll_by_kind.items():
            self.coll_by_kind[kk] += v
        for kk, v in o.n_collectives.items():
            self.n_collectives[kk] += v
        for kk, v in o.coll_by_shape.items():
            self.coll_by_shape[kk] += v
        for kk, v in o.hbm_by_shape.items():
            self.hbm_by_shape[kk] += v


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim, stride 0,
    counts once)."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def tensors_of(tree) -> list:
    """The tensors in ``tree``: a tensor, or lists, tuples and dicts of
    them (an op's arguments and outputs, a parameter tree, a cache)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors_of(x)]
    return []


class _Counter(TorchDispatchMode):
    """Accumulates ``Costs`` over the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.memo: Dict[tuple, tuple] = {}
        self.inside = 0         # > 0 inside a hand-written kernel's call

    def kernel(self, name: str, fn: Callable, flops: int, nbytes: int):
        """``fn()``, a hand-written kernel's plain version, counted as the
        kernel: ``flops`` and ``nbytes`` (``kernels.boundary``)."""
        self.inside += 1
        try:
            out = fn()
        finally:
            self.inside -= 1
        scale = math.prod(common.LOOP_SCALES)
        c = self.costs
        c.flops += scale * flops
        c.hbm_bytes += scale * nbytes
        c.hbm_by_shape[f"{name} {list(out.shape)}"] += scale * nbytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _FREE or func.is_view:
            return func(*args, **kwargs)
        key = _meta_key(func, args, kwargs)
        hit = self.memo.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            hit = self._costs(func, packet, args, kwargs, out)
            if key is not None:
                spec = _out_spec(func, args, kwargs, out)
                if spec is not None:
                    self.memo[key] = hit + (spec,)
        else:
            out = _rebuild(func, hit[-1], args, kwargs)
        flops, nbytes, where = hit[:3]
        scale = math.prod(common.LOOP_SCALES)
        c = self.costs
        c.hbm_bytes_raw += scale * nbytes
        if self.inside:
            return out
        c.flops += scale * flops
        c.hbm_bytes += scale * nbytes
        if nbytes and where:
            c.hbm_by_shape[where] += scale * nbytes
        return out

    def _costs(self, func, packet, args, kwargs, out):
        """(FLOPs, bytes, hbm_by_shape key) of one op."""
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        reads = [(t, tensor_bytes(t)) for t in ins]
        writes = [(t, tensor_bytes(t)) for t in outs]
        if packet in _WRITE_ONLY:
            reads = reads[1:]
        elif packet in _GATHERS and outs:
            reads[0] = writes[0]
        elif packet in _SCATTERS and len(ins) > 1:
            reads[0] = writes[0] = reads[-1]
        nbytes = sum(nb for _, nb in reads + writes)
        where = f"{packet} {list(outs[0].shape)}" if outs else ""
        return flops, nbytes, where


# ------------------------------------------------- meta results, memoized --
# A meta op's result is a function of its arguments' metadata, and a
# model's step repeats the same few hundred ops (every layer, chunk and
# microbatch), so the counter keeps each distinct op's output metadata and
# costs and rebuilds the outputs as empty meta tensors on a repeat.
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError
        return (tuple(a.shape), a.stride(), a.dtype, a.storage_offset())
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if isinstance(a, _HASHABLE):
        return (type(a), a)
    raise TypeError


def _meta_key(func, args, kwargs):
    """The memo key of an op on meta tensors, or None (not memoizable)."""
    try:
        return (func, _arg_key(args),
                tuple((k, _arg_key(v)) for k, v in kwargs.items()))
    except TypeError:
        return None


_ALIAS: Dict[object, object] = {}


def _aliased(func):
    """The name of the argument an in-place or ``out=`` op returns, else
    None."""
    if func not in _ALIAS:
        name = None
        rets = func._schema.returns
        if len(rets) == 1 and rets[0].alias_info is not None:
            sets = rets[0].alias_info.before_set
            for a in func._schema.arguments:
                if a.alias_info is not None and a.alias_info.before_set == sets:
                    name = a.name
                    break
        _ALIAS[func] = name
    return _ALIAS[func]


def _arg(func, args, kwargs, name):
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return kwargs[name] if name in kwargs else args[i]
    raise KeyError(name)


def _out_spec(func, args, kwargs, out):
    """How to rebuild ``out``: ('alias', name) for an op returning one of
    its arguments, or ('new', container, metadata of each tensor); None
    when the output is anything else."""
    name = _aliased(func)
    if name is not None:          # an out= op may resize its out: run it
        return ("alias", name) if out is _arg(func, args, kwargs, name) \
            and name != "out" else None
    if any(r.alias_info is not None for r in func._schema.returns):
        return None
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if not isinstance(outs, (list, tuple)) or not all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in outs):
        return None
    meta = tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs)
    return ("new", "tensor" if single else type(outs), meta)


def _rebuild(func, spec, args, kwargs):
    if spec[0] == "alias":
        return _arg(func, args, kwargs, spec[1])
    _, kind, meta = spec
    outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype in meta]
    return outs[0] if kind == "tensor" else kind(outs)


def count(fn: Callable, *args, **kw) -> Costs:
    """The costs of ``fn(*args, **kw)``: every aten op it dispatches,
    counted by the rules of the module docstring, each hand-written kernel
    at its boundary.  On ``meta`` tensors the run propagates shapes only
    and the sequential loops run one body each
    (``models.common.sampled``)."""
    counter = _Counter()
    common.SAMPLING[0] = True
    boundary.COUNTERS.append(counter)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        common.SAMPLING[0] = False
        boundary.COUNTERS.pop()
    return counter.costs


def roofline(costs: Costs, *, peak_flops: float, hbm_bw: float,
             link_bw: float, links: int = 1) -> Dict[str, float]:
    """Three roofline terms (seconds, one device) and the dominant one."""
    t_compute = costs.flops / peak_flops
    t_memory = costs.hbm_bytes / hbm_bw
    t_coll = costs.coll_bytes / (link_bw * links)
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    t_bound = max(t_compute, t_memory, t_coll)
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "bottleneck": dom,
            "t_bound": t_bound,
            "flops": costs.flops, "hbm_bytes": costs.hbm_bytes,
            "hbm_bytes_raw": costs.hbm_bytes_raw,
            "coll_bytes": costs.coll_bytes}


def spec_roofline(costs: Costs, spec) -> Dict[str, float]:
    """``roofline`` at a ``device.DeviceSpec``'s peaks."""
    return roofline(costs, peak_flops=spec.peak_bf16_flops,
                    hbm_bw=spec.hbm_bw, link_bw=spec.link_bw)


def measure(step: Callable[[], object], *, costs: Costs, model_flops: float,
            spec) -> Dict[str, object]:
    """``step()`` timed on the card beside its counted bound.

    One warm call, then three calls each timed between two CUDA events
    (``t_step``: their median, in s), then one call under
    ``torch.profiler`` tracing the device only (host tracing would
    stretch the call's wall time): ``t_profiled`` its wall time,
    ``t_busy`` the device time of its kernels (None when the profiler
    records no device activity), ``n_kernels`` their launches and ``top``
    the (name, launches, device s) of each kernel, most device time
    first.
    ``share_of_bound`` is ``t_bound / t_step`` and ``mfu`` is
    ``model_flops / (t_step x peak)``, both at ``spec``'s data-sheet
    peaks."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        step()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t_profiled = time.perf_counter() - t0
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    t_step = sorted(times)[len(times) // 2]
    terms = spec_roofline(costs, spec)
    return {**terms, "t_step": t_step, "t_steps": times,
            "t_profiled": t_profiled, "t_busy": busy or None,
            "n_kernels": sum(e.count for e in kern),
            "top": [(e.key, e.count, e.self_device_time_total / 1e6)
                    for e in kern],
            "share_of_bound": terms["t_bound"] / t_step,
            "mfu": model_flops / (t_step * spec.peak_bf16_flops)}
