"""One run of one cell: set-up, the measured window, the comparison, and
the result line.

Set-up builds the configuration's weights on the device from the seed
(``weights.py``), the serving model and ``ServeEngine`` of the program
over its FUSEE prefix-cache pool, and warms up the cell's own shapes with
one wave of requests at the mix's prompt shape and two new tokens (one
prefill, one decode step).  The window then drives the engine with the
mix's clients (``traffic.py``) for ``seconds``: ``submit`` and ``step``,
each token stamped on the host's clock when the step that made it
returns.  Requests still open at the close are served to their end
(untimed, at most a minute) so that each is counted as finished or
failed.  Then the peak memory is read, the program's cache dropped, and
``check.py`` compares what the window served with the plain reference.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, count, trace, weights
from .spec import Cell
from .traffic import Traffic

DRAIN_S = 60.0
WARMUP_NEW = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def port_arch(name: str, cfg: Dict):
    """The program's architecture record for a configuration file."""
    from repro_torch.configs.base import ArchConfig
    w = count.widths(cfg)
    return ArchConfig(
        arch_id=name, family="dense", n_layers=w.layers, d_model=w.d,
        n_heads=w.heads, n_kv_heads=w.kv, d_ff=w.ff, vocab=w.vocab,
        head_dim=w.hd, qk_norm=w.qk_norm, rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"])


def _same_tree(a, b, path="") -> None:
    """Raise unless trees ``a`` and ``b`` have one structure, shapes and
    dtypes."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                sorted(a) != sorted(b):
            raise ValueError(f"weights: {path or 'root'} differs from the "
                             f"program's tree")
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)) or \
                len(a) != len(b):
            raise ValueError(f"weights: {path} differs from the program's")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"weights: {path} is {tuple(a.shape)} {a.dtype}, "
                         f"the program's {tuple(b.shape)} {b.dtype}")


@dataclasses.dataclass
class Track:
    req: object
    key: tuple
    t_submit: float
    times: List[float] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None


class Admits:
    """Every group of requests the engine admits, in order (what the
    pool's comparison replays), recorded around ``ServeEngine._admit``."""

    def __init__(self, engine):
        self.groups: List[list] = []
        self.last: list = []
        fn = engine._admit

        def admit():
            n = min(len(engine.queue), len(engine.slots_free))
            group = list(engine.queue[:n])
            out = fn()
            self.last = group
            if group:
                self.groups.append(group)
            return out
        engine._admit = admit


class Run:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    def __init__(self, widths: count.Widths, peaks: Dict,
                 spans: trace.Spans, profile: Optional[Dict]):
        self.widths = widths
        self.peak_flops = peaks["bf16_flops"]
        self.peak_bw = peaks["hbm_bytes_per_s"]
        self.spans = spans
        self.profile = profile

    def steady(self, name: str) -> list:
        """Spans ``name`` taken while the profiler was off, or all where
        every one was taken under it."""
        return self.spans.of(name, False) or self.spans.of(name)

    def bound_s(self, cost: Dict[str, float]) -> float:
        return count.bound_s(cost, self.peak_flops, self.peak_bw)

    def bound_kind(self, cost: Dict[str, float]) -> str:
        return count.bound_kind(cost, self.peak_flops, self.peak_bw)

    def count_prefill(self, batch: int, seq: int) -> Dict[str, float]:
        return count.prefill(self.widths, batch, seq)

    def count_decode(self, batch: int, valid: int) -> Dict[str, float]:
        return count.decode(self.widths, batch, valid)

    def count_flash(self, batch: int, seq: int) -> Dict[str, float]:
        return count.flash_call(self.widths, batch, seq)

    def count_paged(self, batch: int, valid: int) -> Dict[str, float]:
        return count.paged_call(self.widths, batch, valid)


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _instrument(engine, model, admits: Admits, mix: Dict, dev, sync):
    """The traced run's spans, and its profiler where there is a card."""
    spans = trace.Spans(sync, dev.type == "cuda")
    spans.wrap(engine, "_admit", "perfbench.admit", lambda a, o: {
        "admitted": len(admits.last),
        "prompt_tokens": sum(len(r.prompt) for r in admits.last)})
    spans.wrap(model, "prefill", "perfbench.prefill", lambda a, o: {
        "batch": a[1].shape[0], "seq": a[1].shape[1]}, device=True)
    spans.wrap(model, "decode_step", "perfbench.decode", lambda a, o: {
        "batch": a[2].shape[0], "valid": int(o[1]["length"])}, device=True)
    spans.wrap(engine, "_emit", "perfbench.emit")
    spans.wrap(engine, "step", trace.STEP, sync=True)
    prof = None
    if dev.type == "cuda":      # the profiler traces the card's activity
        prof = trace.WaveProfiler(spans, mix["profile_waves"])
        prof.warm(lambda: (torch.ones(1024, device=dev) * 2).sum().item())
    return spans, prof


def _drive(engine, traffic: Traffic, seconds: float, prof, request_cls):
    """The window: the mix's clients submit and the engine steps until
    ``seconds`` have passed, then the requests still open are served to
    their end (at most ``DRAIN_S`` more).  Returns every request's
    ``Track``, the window's end, and the admitting steps taken."""
    tracks: Dict[int, Track] = {}
    open_: set = set()

    def submit(key, t):
        prompt, new = traffic.request(*key)
        req = request_cls(rid=len(tracks), prompt=prompt, max_new=new)
        tracks[req.rid] = Track(req, key, t)
        open_.add(req.rid)
        engine.submit(req)

    t0 = time.perf_counter()
    t_end = t0 + seconds
    arrivals = [] if traffic.closed else traffic.arrivals(seconds)
    nxt = 0
    if traffic.closed:
        for c in range(traffic.mix["clients"]):
            submit((c, 0), t0)
    prefills = 0
    while True:
        now = time.perf_counter()
        closed = now >= t_end
        if closed and (not open_ or now >= t_end + DRAIN_S):
            break
        while not closed and nxt < len(arrivals) and \
                t0 + arrivals[nxt] <= now:
            submit((nxt,), t0 + arrivals[nxt])
            nxt += 1
        if not engine.queue and not engine.active:
            if closed or nxt >= len(arrivals):
                break
            time.sleep(max(0.0, t0 + arrivals[nxt] - now))
            continue
        admitting = bool(engine.queue and engine.slots_free)
        if prof is not None:
            if closed:
                prof.stop()
            else:
                prof.before_step(admitting, prefills)
        prefills += int(admitting)
        n_fin = len(engine.finished)
        engine.step()
        t = time.perf_counter()
        for r in open_:
            tr = tracks[r]
            n = len(tr.req.out)
            if n > len(tr.times):
                tr.times += [t] * (n - len(tr.times))
        for req in engine.finished[n_fin:]:
            tr = tracks[req.rid]
            tr.t_done = t
            open_.discard(req.rid)
            if traffic.closed and t < t_end:
                submit((tr.key[0], tr.key[1] + 1), t)
    if prof is not None:
        prof.stop()
    return list(tracks.values()), t_end, prefills


def _end_to_end(cell: Cell, window: List[Track], t_end: float,
                seconds: float, setup_s: float) -> Dict[str, Dict]:
    toks = [x for tr in window for x in tr.times if x <= t_end]
    ttft = [1e3 * (tr.times[0] - tr.t_submit) for tr in window
            if tr.times and tr.times[0] <= t_end]
    gaps = [(b, 1e3 * (b - a)) for tr in window
            for a, b in zip(tr.times, tr.times[1:]) if b <= t_end]
    itl = [g for _, g in gaps]
    log(f"[window] {len(toks)} tokens; ttft ms median "
        f"{statistics.median(ttft) if ttft else None!r} over {len(ttft)}; "
        f"itl ms median {statistics.median(itl) if itl else None!r} over "
        f"{len(itl)}")
    first = [1e3 * (b - a) for tr in window
             for a, b in zip(tr.times[:1], tr.times[1:2]) if b <= t_end]
    later = [1e3 * (b - a) for tr in window
             for a, b in zip(tr.times[1:], tr.times[2:]) if b <= t_end]
    if first and later:
        log(f"[window] itl ms median of each request's first gap "
            f"{statistics.median(first)!r} ({len(first)}), p95 of the "
            f"later gaps {_percentile(later, 95)!r}")
    t0 = t_end - seconds        # where the window's gaps sit in it
    fifths = [[g for b, g in gaps if int(5 * (b - t0) / seconds) == i]
              for i in range(5)]
    log(f"[window] itl ms median by fifth of the window: "
        f"{[round(statistics.median(f), 3) if f else None for f in fifths]}")
    values = {"out_tokens_per_s": len(toks) / seconds,
              "ttft_p90_ms": _percentile(ttft, 90) if ttft else None,
              "itl_p95_ms": _percentile(itl, 95) if itl else None,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def _per_layer(cell: Cell, run: Run) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        reader = cell.reader(m["name"])
        v = reader.read(run)
        note = reader.explain(run) if hasattr(reader, "explain") else ""
        log(f"[layer] {m['name']} = {v!r} {m['unit']} {note}")
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _breakdown(summary: Dict, spans: trace.Spans) -> Dict:
    log(f"[trace] busy {summary['busy_s']!r} s of {summary['window_s']!r} "
        f"s; kernels {sum(summary['kernel_calls'].values())}")
    for name in ("perfbench.prefill", "perfbench.decode"):
        on, off = spans.of(name, True), spans.of(name, False)
        if on and off:          # what the profiler costs a call
            log(f"[trace] {name} mean device s: profiled "
                f"{statistics.mean(x.dev_s for x in on)!r} ({len(on)}), "
                f"not {statistics.mean(x.dev_s for x in off)!r} "
                f"({len(off)}); the host's launching, not profiled: "
                f"{statistics.mean(x.s for x in off)!r}")
    top = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def _decode_steps(spans: trace.Spans) -> None:
    """The traced run's decode steps (those that admitted nothing), wall
    ms, to set beside an untraced run's gaps between tokens."""
    admits = [s for s in spans.of("perfbench.admit")
              if s.attrs["admitted"]]
    for profiled in (False, True):
        walls = [1e3 * st.s for st in spans.of(trace.STEP, profiled)
                 if not any(st.t0 <= a.t0 <= st.t1 for a in admits)]
        if walls:
            log(f"[trace] decode steps, profiler {'on' if profiled else 'off'}"
                f": wall ms median {statistics.median(walls)!r} over "
                f"{len(walls)}")


def _compare(cell: Cell, engine, admits: Admits, tree: Dict, traffic,
             done: List, control: bool) -> tuple:
    """Every number compared, with its limit (``check.py``).  With
    ``control`` the tokens judged are the fp8 control's instead of the
    served ones (``check.logit_gap``)."""
    numbers = check.pool_numbers(engine, admits.groups)
    numbers["requests_wrong_length"] = sum(len(r.out) != r.max_new
                                           for r in done)
    sample = traffic.sample(done, cell.traffic["check_requests"])
    t_ref = time.perf_counter()
    gap = (check.logit_gap(cell.config, tree, sample, control)
           if sample else {})
    log(f"[check] reference over {len(sample)} requests (slots "
        f"{sorted({r.slot for r in sample})}), "
        f"{gap.get('tokens_compared', 0)} served tokens: "
        f"{time.perf_counter() - t_ref:.1f} s")
    if control:
        log(f"[check] control: the fp8 reference's first tokens judged in "
            f"place of the served ones, whose gap read "
            f"{gap.get('served_gap')!r}")
    numbers["logit_gap"] = gap.get("logit_gap", float("inf"))
    limits = {k: 0 for k in numbers}
    limits["logit_gap"] = cell.limits["logit_gap"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k, c in checks.items():
        log(f"[correct] {k} {c['value']!r} limit {c['limit']!r}")
    return checks, gap.get("served_gap")


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            device: str, t_start: float, card: str, peaks: Dict,
            faults: Optional[Callable] = None, control: bool = False) -> Dict:
    """One run; returns the result line's object.  ``faults(engine,
    model)`` may break the timed path (the harness's own tests);
    ``control`` puts the fp8 control in the program's place for the
    comparison (``calibrate.py``, the control's test), and adds the
    served tokens' own gap as ``served_gap``."""
    from repro_torch.models.model import Model
    from repro_torch.serving import PoolConfig, Request, ServeEngine
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg, mix = cell.config, cell.traffic
    w = count.widths(cfg)

    model = Model(port_arch(cell.config_name, cfg), device=dev)
    t_w = time.perf_counter()
    tree = weights.draw(w, seed, dev, cfg["torch_dtype"])
    sync()
    t_w = time.perf_counter() - t_w
    params = weights.program_tree(tree)
    _same_tree(params, model.abstract_params())
    engine = ServeEngine(model, params, max_batch=mix["max_batch"],
                         max_len=mix["max_len"],
                         pool_cfg=PoolConfig(**cfg["pool"]),
                         seed=weights.seed64(seed))
    admits = Admits(engine)
    traffic = Traffic(mix, w.vocab, seed)
    warm = traffic.warmup()
    for i, p in enumerate(warm):
        engine.submit(Request(rid=-1 - i, prompt=p, max_new=WARMUP_NEW))
    t_warm = time.perf_counter()
    while engine.queue or engine.active:
        engine.step()
    engine.finished.clear()
    sync()
    log(f"[setup] {cell.config_name}: {weights.nbytes(tree)} bytes of "
        f"weights from seed {seed} in {t_w!r} s; warm-up "
        f"{len(admits.groups)} admission(s) of {len(warm)} x "
        f"{len(warm[0])} tokens, {WARMUP_NEW} new each, in "
        f"{time.perf_counter() - t_warm!r} s")
    spans, prof = (_instrument(engine, model, admits, mix, dev, sync)
                   if traced else (None, None))
    if faults is not None:
        faults(engine, model)

    setup_s = time.perf_counter() - t_start
    window, t_end, prefills = _drive(engine, traffic, seconds, prof,
                                         Request)
    sync()
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    done = [tr.req for tr in window
            if tr.t_done is not None and tr.t_done <= t_end]
    failed = [tr for tr in window
              if tr.t_done is None or check.request_failed(tr.req)]
    log(f"[window] {seconds} s: {len(window)} requests submitted, "
        f"{len(done)} finished in the window, {len(failed)} failed; "
        f"{prefills} admitting steps; pool {engine.pool.stats}")
    device_info = {"platform": "gpu" if cuda else device, "kind": card,
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    metrics = _end_to_end(cell, window, t_end, seconds, setup_s)
    if traced:
        summary = prof.summary() if prof else None
        log(f"[count] {count.ASSUMPTIONS} Peaks {peaks['bf16_flops']!r} "
            f"FLOP/s, {peaks['hbm_bytes_per_s']!r} B/s ({card}, power "
            f"limit {cell.power_limit})")
        metrics = _per_layer(cell, Run(w, peaks, spans, summary))
        if summary:
            device_info.update(busy_s=summary["busy_s"],
                               window_s=summary["window_s"])
            breakdown = _breakdown(summary, spans)
        _decode_steps(spans)

    engine.cache = None                 # the reference runs beside the weights
    if cuda:
        torch.cuda.empty_cache()
    checks, served_gap = _compare(cell, engine, admits, tree, traffic,
                                  done, control)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(window), "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    if control:
        result["served_gap"] = served_gap
    result["checks"] = checks
    return result
