"""Shared helpers of the ``test_torch_*`` files: the PyTorch port
(``repro_torch``) held against the JAX package (``repro``) on the CPU.

Integer paths compare exactly (tolerance 0).  State crosses between the two
packages only as numpy arrays and plain dicts.
"""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture
def ref_c1_fixed(monkeypatch):
    """The JAX package's ``FuseeClient`` with the port's fix of ROADMAP C1,
    for the test that uses this fixture only (``monkeypatch`` restores both
    methods at teardown).

    The reference keeps an object's log middle word (next pointer, opcode)
    in one per-client field, ``_pending_mid``, set by ``_prepare_object``
    and read by ``_commit_log_verbs``; with two writes in flight on a
    client, a later prepare overwrites it before an earlier op commits.
    The port carries the word with its op.  Here the reference carries it
    per object pointer (the ops in flight on one client hold distinct
    objects), so every byte, history and audit comparison stays strict and
    compares the same protocol.  A module that compares the two packages on
    a run with more than one op in flight applies it to every test:
    ``pytestmark = pytest.mark.usefixtures("ref_c1_fixed")``."""
    from repro.core.client import FuseeClient
    prepare, commit = FuseeClient._prepare_object, \
        FuseeClient._commit_log_verbs

    def _prepare_object(self, key, value, opcode):
        prep = yield from prepare(self, key, value, opcode)
        if prep is not None:
            self.__dict__.setdefault("_c1_mids", {})[prep[0]] = \
                self._pending_mid
        return prep

    def _commit_log_verbs(self, obj_ptr, obj_sc, v_old):
        self._pending_mid = self._c1_mids[obj_ptr]
        return commit(self, obj_ptr, obj_sc, v_old)

    monkeypatch.setattr(FuseeClient, "_prepare_object", _prepare_object)
    monkeypatch.setattr(FuseeClient, "_commit_log_verbs", _commit_log_verbs)


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided at
    run time, never at import: every xdist worker collects the same
    tests)."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no "
                    "interpret mode")


def port_config(ref_cfg):
    """The port's DMConfig with every field of a reference DMConfig."""
    from repro_torch.core import DMConfig
    return DMConfig(**dataclasses.asdict(ref_cfg))


def ref_state(pool) -> dict:
    """A reference pool's state as plain numpy arrays and dicts, in the
    keyword form of ``repro_torch`` ``DMPool.load_numpy_state``."""
    return dict(slab_words=pool.slab.buf.copy(),
                cells=dict(pool.slab.cells),
                placement={g: list(r) for g, r in pool.placement.items()},
                alive=[m.alive for m in pool.mns],
                members=list(pool.directory.members),
                epoch=pool.epoch,
                mn_bytes=pool.mn_bytes.copy(),
                versions=dict(pool.directory.versions),
                ordered_regions=list(pool.ordered_regions))


def port_pool_like(ref_pool):
    """A CPU port pool holding a byte-for-byte copy of ``ref_pool``."""
    from repro_torch.core import DMPool
    pool = DMPool(port_config(ref_pool.cfg),
                  num_clients=ref_pool.num_clients, device="cpu")
    pool.load_numpy_state(**ref_state(ref_pool))
    return pool


def slab_u64(pool) -> np.ndarray:
    buf = pool.slab.buf
    if isinstance(buf, torch.Tensor):
        return buf.cpu().numpy().view(np.uint64)
    return buf


def norm(x):
    """A verb result as plain Python ints (None stays None)."""
    if x is None:
        return None
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if np.ndim(x) == 0:
        return int(x)
    return [int(v) for v in np.asarray(x, dtype=object).ravel()]


def norm_list(xs):
    return [norm(x) for x in xs]


def assert_same_typed(ref, got):
    """Unsigned results must come back as the reference's types: np.uint64
    scalars and np.uint64 arrays, so op histories agree on words >= 2^63."""
    for a, b in zip(ref, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype
        elif isinstance(a, np.integer):
            assert type(b) is type(a)


# --------------------------------------------------------------- signatures
def pool_bytes(cl) -> bytes:
    out = []
    for mn in cl.pool.mns:
        for g in sorted(mn.regions):
            a = mn.regions[g]
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.ascontiguousarray(a)
            out.append(a.tobytes())
    return b"".join(out)


def health_signature(cl):
    h = cl.health()
    return (h.epoch, h.tick, h.crashed_ops, h.client_recoveries,
            h.mn_recoveries,
            tuple((m.mid, m.alive, m.primary_regions, m.hosted_regions,
                   m.bytes_served) for m in h.mns),
            tuple((c.cid, c.status, c.epoch, c.inflight, c.cache_entries,
                   c.completed_ops, c.crashed_ops) for c in h.clients))


def history_signature(cl):
    return tuple(
        (r.cid, r.op_id, r.kind, r.key, r.inv_tick, r.resp_tick, r.rtts,
         r.bg_rtts, r.result.status,
         tuple(r.result.value) if isinstance(r.result.value, list) else None)
        for r in cl.scheduler.history if r.result is not None)


FLEET_COUNTERS = ("ticks", "verbs", "array_calls", "master_calls",
                  "max_lanes", "index_probe_verbs", "probe_invocations",
                  "probe_keys", "probe_hits", "shadow_rebuilds",
                  "ord_leaf_verbs", "scan_locate_invocations",
                  "scan_locate_keys", "fused_ticks", "fallback_ticks",
                  "verbs_read",
                  "verbs_write", "verbs_cas", "verbs_faa", "verbs_alloc",
                  "verbs_free")


def counter_signature(fleet):
    if fleet is None:
        return None
    st = fleet.stats()
    return {k: st[k] for k in FLEET_COUNTERS if k in st}


def signature(cl, fleet=None) -> dict:
    """Every path-independent fact of a run (the fused-tick oracle's
    signature minus the metrics registry, which ``obs_signature``
    holds)."""
    return {"pool_bytes": pool_bytes(cl),
            "health": health_signature(cl),
            "history": history_signature(cl),
            "counters": counter_signature(fleet),
            "mn_bytes": tuple(int(b) for b in cl.pool.mn_bytes)}


def obs_signature(O, cl) -> dict:
    """A run's observability surface as plain data (``O`` is the
    package's ``obs`` module): ``json.dumps`` of ``deterministic_view(
    cl.metrics())`` (the ``hotspot`` block included when enabled), the
    flight ring's columns and labels; with a verb tracer attached, its
    ring's columns and labels, the span trees' columns and ``profile()``
    without its wall-clock ``tick_phases``."""
    import json
    out = {"metrics": json.dumps(O.deterministic_view(cl.metrics()),
                                 sort_keys=True),
           "flight_labels": cl.obs.labels()}
    for f, col in cl.obs.flight_events().items():
        out["flight." + f] = col.tolist()
    tr = cl.pool._tracer
    if tr is not None:
        out["trace_labels"] = tr.labels
        for f, col in tr.events().items():
            out["trace." + f] = col.tolist()
        prof = cl.profile()
        ss = prof.pop("spans")
        prof.pop("tick_phases", None)
        out["profile"] = json.dumps(prof, sort_keys=True)
        for part in ("spans", "ops"):
            for f, col in getattr(ss, part).items():
                out[f"{part}.{f}"] = col.tolist()
    return out


def choice_rows(choices) -> tuple:
    """Scheduler choices as plain tuples (each package has its own
    ``Choice`` class, and dataclasses of two classes never compare
    equal)."""
    return tuple((c.kind, c.cid, c.mn, c.name) for c in choices)


def explore_signature(res) -> dict:
    """An ``ExploreResult`` without its wall time: every count, the visit
    digest, ``complete`` and each violation's kind with its minimized (or,
    if not minimized, full) schedule, and the details."""
    return {"states": res.states, "executions": res.executions,
            "transitions": res.transitions,
            "replay_fires": res.replay_fires, "dedup_cuts": res.dedup_cuts,
            "sleep_blocks": res.sleep_blocks, "complete": res.complete,
            "visit_digest": res.visit_digest,
            "violations": [(v.kind, choice_rows(
                v.minimized if v.minimized is not None else v.schedule))
                for v in res.violations],
            "details": [v.detail for v in res.violations]}


def assert_same_run(ref, port):
    for k in ref:
        assert ref[k] == port[k], f"port/reference divergence in {k}"


# ------------------------------------------------------------ sanitizers
def step_cluster(M, num_clients=4, r=3, num_mns=4, **pool_kw):
    """tests/test_property.py's step-mode harness on either package's
    ``core`` (``M``): a pool (``pool_kw`` goes to ``DMPool``, e.g.
    ``device=``), its master, ``num_clients`` clients and a scheduler."""
    pool = M.DMPool(M.DMConfig(num_mns=num_mns, replication=r),
                    num_clients=num_clients, **pool_kw)
    master = M.Master(pool)
    clients = [M.FuseeClient(i, pool) for i in range(num_clients)]
    sched = M.Scheduler(pool, master)
    for c in clients:
        sched.add_client(c)
    return pool, master, clients, sched


def crash_during_commit(M, seed, steps, **pool_kw):
    """tests/test_property.py::test_crash_during_commit_history_linearizable
    at one draw: client 1 pipelines two writes of key 9 (the second a
    DELETE when ``seed % 3 == 0``), client 2 an update and a search; after
    ``steps`` random verb-boundary steps client 1 crashes, the master
    recovers it (§5.3) onto client 2, the survivors finish and a final
    SEARCH reads the key.  Returns the scheduler and the CRASHED records of
    key 9.  ``chip_smoke.py`` runs it on ``cuda`` and on ``cpu``."""
    rng = np.random.default_rng(seed)
    pool, master, clients, sched = step_cluster(M, num_clients=3, **pool_kw)
    rec0 = sched.submit(clients[0].cid, "insert", 9, [1])
    sched.run_round_robin()
    assert rec0.result.status == "OK"
    sched.submit(clients[1].cid, "update", 9, [20])
    sched.submit(clients[1].cid, "delete" if seed % 3 == 0 else "update",
                 9, None if seed % 3 == 0 else [21])
    sched.submit(clients[2].cid, "update", 9, [30])
    sched.submit(clients[2].cid, "search", 9)
    for _ in range(steps):
        cids = sched.eligible_cids()
        if not cids:
            break
        sched.step(cids[int(rng.integers(len(cids)))],
                   pick=int(rng.integers(4)))
    sched.crash_client(1)
    master.recover_client(1, reassign_to=clients[2])
    sched.run_random(rng=rng)
    sched.submit(clients[2].cid, "search", 9)
    sched.run_round_robin()
    crashed = [r for r in sched.history
               if r.key == 9 and r.result is not None
               and r.result.status == "CRASHED"]
    return sched, crashed


def linearizes(lin, records, key, crashed=()) -> bool:
    """Whether ``records``' history of ``key`` linearizes under checker
    module ``lin`` (either package's ``core.linearize``).  With ``crashed``
    records: true iff SOME subset of the crashed writes can be taken as
    applied — a never-responding op may linearize anywhere after its
    invocation (the CRASHED contract: at most once, never partially)."""
    import itertools
    hops = lin.records_to_hops(records, key)
    writes = [r for r in crashed if r.kind in ("insert", "update", "delete")]
    for n in range(len(writes) + 1):
        for sub in itertools.combinations(writes, n):
            extra = [lin.HOp(op_id=r.op_id, kind=r.kind, inv=r.inv_tick,
                             resp=10 ** 9,
                             wrote=tuple(r.value)
                             if r.value is not None else None,
                             read=None, status="OK")
                     for r in sub]
            if lin.check_linearizable(hops + extra, initial=None):
                return True
    return False


def lost_write_run(M, **kw):
    """tests/test_analysis.py::test_regression_lost_write_cas_race's run on
    either package (``kw`` goes to ``FuseeCluster``): two clients insert
    different keys sharing a primary bucket, under a verb tracer.  Returns
    the cluster, its race findings and both keys' values read back."""
    cfg = M.DMConfig()
    k1 = 1001
    b1 = M.race.bucket_pair(k1, cfg.index_buckets)[0]
    k2 = next(k for k in range(2000, 100000)
              if M.race.bucket_pair(k, cfg.index_buckets)[0] == b1)
    cl = M.FuseeCluster(num_clients=2, seed=3, **kw)
    cl.attach_tracer()
    s0, s1 = cl.store(0, max_inflight=0), cl.store(1, max_inflight=0)
    f1 = s0.submit(M.Op.put(k1, [11]))
    f2 = s1.submit(M.Op.put(k2, [22]))
    cl.drain()
    assert f1.result().status == "OK" and f2.result().status == "OK"
    return cl, cl.race_findings(), (s0.get(k1), s1.get(k2))


def finding_rows(findings) -> list:
    """Race findings as plain tuples (every field)."""
    return [(f.rule, f.region, f.replica, f.off, f.cids, f.verbs, f.op_ids,
             f.seqs, f.detail) for f in findings]


def heap_rows(rep) -> tuple:
    """A heap audit's errors, warnings and stats."""
    return rep.errors, rep.warnings, rep.stats


# ------------------------------------------------------------ attention
def attn_bound(want, spread):
    """Per-element bound on |kernel - plain| for an attention output.
    ``want`` is the plain version's output and ``spread`` the plain version
    run on |v| (each row's weighted mean of |v|).  float32: 2e-5 + 2e-5 x
    |want| (summation order).  bfloat16: 2^-7 x |want| + 2^-8 x spread: both
    outputs are rounded to bf16, and one unit in the last place is at most
    2^-7 of the value; a kernel may round each attention weight to bf16
    before P.V, which moves the output by at most 2^-9 of the weighted mean
    of |v| (allowed twice).  ``chip_smoke.py`` uses it too."""
    w = want.float().abs()
    if want.dtype == torch.float32:
        return 2e-5 + 2e-5 * w
    return 2 ** -7 * w + 2 ** -8 * spread.float()


def uniform_attn_inputs(q, v):
    """Inputs whose attention weights are exact in bfloat16: q = 0 (every
    visible key weighs 1) and v = +-1 from the sign of ``v``.  Each output
    is then (sum of +-1 over the visible keys) / their count, so one key
    too many or too few in a row moves it by about 1/count, far above the
    bound 1e-4 + 2^-7 x |want| that rounding needs."""
    return torch.zeros_like(q), torch.where(v < 0, -1.0, 1.0).to(v.dtype)


# ------------------------------------------------------------ serving
def serve_scenario(Eng, Req, Pool, block_hashes, model, params):
    """tests/test_serving.py's engine scenario: 4 requests sharing a
    64-token prefix, max_batch 2, max_len 128.  Takes either package's
    engine, request, pool config and ``_block_hashes``; returns the engine,
    the finished requests and the SEARCH result of every prompt block.
    ``chip_smoke.py`` runs it too (the reduced cuda-vs-cpu check)."""
    eng = Eng(model, params, max_batch=2, max_len=128,
              pool_cfg=Pool(n_pages=256, n_buckets=64, slots_per_bucket=4))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 128, 64).astype(np.int32)
    prompts = []
    for i in range(4):
        tail = rng.integers(0, 128, 16).astype(np.int32)
        prompts.append(np.concatenate([shared, tail]))
        eng.submit(Req(rid=i, prompt=prompts[-1], max_new=4))
    done = eng.run(max_ticks=60)
    keys = np.concatenate([block_hashes(p) for p in prompts])
    return eng, done, eng.pool.search(keys)


def serve_signature(eng, done, search) -> dict:
    """What two runs of ``serve_scenario`` must agree on: each request's
    tokens and prefix hits, every prompt block's SEARCH result, whether
    the index replicas converged, and the ordered listing of the cached
    prefixes (``list_prefixes``)."""
    return {"requests": [(q.rid, list(q.out), q.prefix_hits) for q in done],
            "search": (np.asarray(search[0]).tolist(),
                       np.asarray(search[1]).tolist()),
            "converged": eng.pool.check_replicas_converged(),
            "listing": eng.list_prefixes(0, 64)}


def port_serve_run(model, params) -> dict:
    """``serve_scenario`` on the port, as its ``serve_signature``."""
    from repro_torch.serving import PoolConfig, Request, ServeEngine
    from repro_torch.serving.engine import _block_hashes
    return serve_signature(*serve_scenario(ServeEngine, Request, PoolConfig,
                                           _block_hashes, model, params))


# --------------------------------------------------------- ordered keydir
SPLIT_PHASES = frozenset((
    "ord:alloc_leaf", "ord:write_leaf", "ord:link", "ord:link_backups",
    "ord:post_link_read", "ord:read_new", "ord:move_claim",
    "ord:move_backups", "ord:split_clear_backups", "ord:split_clear"))


def ycsbe_crash_scenario(M, *, seed=7, n_clients=12, n_keys=96,
                         ops_per_client=6, **kw):
    """A small seeded YCSB-E fleet run (95% SCAN with a zipf-skewed start
    and a length uniform in 1..100, 5% INSERT of fresh keys, 4 ops in
    flight per client) in which the first client seen inside a leaf split
    is crashed on that tick and recovered 6 ticks later.  Takes either
    package's ``repro.core`` (``kw`` goes to ``FuseeCluster``, e.g.
    ``device=``); returns the cluster, its fleet engine, the tick and the
    client of the crash, and the settled futures.  ``chip_smoke.py`` runs
    it on ``cuda`` and on ``cpu``; the tests hold it against the JAX
    package."""
    cfg = M.DMConfig(num_mns=4, replication=2, ordered_index=True,
                     region_words=1 << 15, regions_per_mn=8)
    cl = M.FuseeCluster(cfg, num_clients=n_clients, seed=seed, **kw)
    fleet = cl.fleet()
    sched = cl.scheduler
    for k in range(n_keys):
        sched.submit(k % n_clients, "insert", k, [k, k])
    fleet.run()
    plans, _ = ycsbe_plans(M, cl.rng.stream("workload"), n_keys, n_clients,
                           ops_per_client,
                           lambda k: M.Op.insert(k, [k, k]))
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    cursor = [0] * n_clients
    futs, crash, tick, recovered = [], None, 0, False
    while True:
        wave = []
        for c in range(n_clients):
            room = 4 - sched.inflight(c)
            if (cl.clients[c].crashed or room <= 0
                    or cursor[c] >= len(plans[c])):
                continue
            wave.append((backends[c], plans[c][cursor[c]:cursor[c] + room]))
            cursor[c] += len(wave[-1][1])
        if wave:
            for fs in fleet.submit_wave(wave):
                futs.extend(fs)
        if crash is None:
            mid = [c for c in range(n_clients)
                   if c in sched.pipes and any(
                       r.phase_label in SPLIT_PHASES
                       for r in sched.pipes[c].runs.values())]
            if mid:
                crash = (tick, mid[0])
                cl.crash_client(mid[0])
        elif tick == crash[0] + 6:
            cl.recover_client(crash[1])
            recovered = True
        if not sched.has_work() and all(
                cursor[c] >= len(plans[c]) or cl.clients[c].crashed
                for c in range(n_clients)):
            break
        fleet.tick()
        tick += 1
    if crash is not None and not recovered:
        cl.recover_client(crash[1])
    cl.drain()
    return cl, fleet, crash, futs


def ycsbe_crash_audit(M, cl, futs) -> dict:
    """What must hold after ``ycsbe_crash_scenario``: every SCAN result is
    sorted, deduplicated and >= its start; every acknowledged key is in the
    keydir and in a final full scan."""
    acked = set(range(96))
    for f in futs:
        r = f.result()
        rec = f.record
        if rec.kind == "insert" and r.status == "OK":
            acked.add(rec.key)
        if rec.kind == "scan" and r.status == "OK":
            keys = [k for k, _v in r.value]
            assert keys == sorted(set(keys)) and all(
                k >= rec.key for k in keys), f"torn scan from {rec.key}"
    live = next(c for c in sorted(cl.clients) if not cl.clients[c].crashed)
    final = [k for k, _v in cl.store(live).scan(0, 10_000)]
    keydir = set(M.ordered.ordered_keys_direct(cl.pool))
    assert acked <= set(final), "an acked insert is missing from a scan"
    assert acked <= keydir, "an acked insert is missing from the keydir"
    return {"acked": len(acked), "final": len(final), "keydir": len(keydir)}


# ------------------------------------------------------- YCSB-E at scale
def zipf_keys(n_keys: int, theta: float, size: int, rng):
    """``size`` keys in ``[0, n_keys)``, rank r drawn with weight r^-theta."""
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** (-theta)
    return rng.choice(n_keys, size=size, p=p / p.sum())


def drive_waves(fleet, backends, plans, depth: int = 4) -> list:
    """Closed loop: refill every client to ``depth`` in-flight ops through
    ``submit_wave``, tick the fleet until the plans drain.  Returns the
    futures in submission order."""
    sched = fleet.sched
    cursor = [0] * len(plans)
    futs = []
    while True:
        wave = []
        for c, plan in enumerate(plans):
            room = depth - sched.inflight(c)
            if room > 0 and cursor[c] < len(plan):
                ops = plan[cursor[c]:cursor[c] + room]
                cursor[c] += len(ops)
                wave.append((backends[c], ops))
        if wave:
            for fs in fleet.submit_wave(wave):
                futs.extend(fs)
        if not sched.has_work():
            break
        fleet.tick()
    return futs


def ycsbe_load_plans(n_keys: int, n_clients: int, seed: int, insert):
    """YCSB's load phase: keys ``0..n_keys-1`` in a seeded random (hashed)
    order, the i-th inserted by client ``i % n_clients``; ``insert(key)``
    makes the op.  Run with ``drive_waves`` (4 in flight per client)."""
    order = np.random.default_rng(seed).permutation(n_keys)
    return [[insert(int(k)) for k in order[c::n_clients]]
            for c in range(n_clients)]


def ycsbe_plans(M, wl, n_keys: int, n_clients: int, ops_per_client: int,
                insert, theta: float = 0.99):
    """YCSB-E (``benchmarks/common.py:211-214``) drawn from the workload
    stream ``wl``: 95% SCAN with a zipf start over the loaded keys and a
    length uniform in 1..100, 5% INSERT of fresh keys from ``n_keys`` up.
    Returns the per-client plans and the number of scans."""
    n_ops = n_clients * ops_per_client
    starts = zipf_keys(n_keys, theta, n_ops, wl)
    is_scan = wl.random(n_ops) < 0.95
    lens = 1 + wl.integers(100, size=n_ops)
    plans = [[] for _ in range(n_clients)]
    fresh = n_keys
    for i in range(n_ops):
        if is_scan[i]:
            op = M.Op.scan(int(starts[i]), int(lens[i]))
        else:
            op, fresh = insert(fresh), fresh + 1
        plans[i % n_clients].append(op)
    return plans, int(is_scan.sum())


def _host_words(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ycsbe_audit(M, cl, n_keys: int, values: dict, futs) -> dict:
    """What a YCSB-E fleet run over the keydir must show, on either
    package: every INSERT acknowledges; every SCAN returns OK or the
    protocol's NOT_FOUND, and an OK one is sorted, deduplicated and >= its
    start; the keydir holds no key that was never acknowledged and misses
    exactly as many acknowledged keys as the clients counted in
    ``ord_full_drops``; an OK SCAN whose window lies inside the loaded keys
    returns the keydir's next ``count`` loaded keys from its start (that is
    ``range(start, start + count)`` when nothing was dropped) with the
    values ``values`` holds for them; the keydir's replicas are equal.
    Returns the counts."""
    pool = cl.pool
    keydir = M.ordered.ordered_keys_direct(pool)
    kset = set(keydir)
    status: dict = {}
    acked = set()
    for f in futs:
        r = f.result()
        status[(f.record.kind, r.status)] = \
            status.get((f.record.kind, r.status), 0) + 1
        if f.record.kind == "insert" and r.status == "OK":
            acked.add(f.record.key)
    assert set(status) <= {("insert", "OK"), ("scan", "OK"),
                           ("scan", "NOT_FOUND")}, status
    drops = sum(c.ord_full_drops for c in cl.clients.values())
    assert kset <= acked, f"{len(kset - acked)} keydir keys never acked"
    missing = acked - kset
    assert len(missing) == drops, \
        f"{len(missing)} acked keys missing from the keydir, {drops} dropped"
    loaded = np.array([k for k in keydir if k < n_keys], np.int64)
    ok = exact = 0
    for f in futs:
        rec, r = f.record, f.result()
        if rec.kind != "scan" or r.status != "OK":
            continue
        keys = [k for k, _v in r.value]
        assert keys == sorted(set(keys)) and all(k >= rec.key for k in keys), \
            f"torn scan from {rec.key}"
        ok += 1
        lo = int(np.searchsorted(loaded, rec.key))
        want = loaded[lo:lo + rec.value].tolist()
        if rec.key + rec.value <= n_keys and len(want) == rec.value:
            assert keys == want and all(
                list(v) == list(values[k]) for k, v in r.value), \
                f"scan({rec.key}, {rec.value}) differs from the keydir"
            exact += 1
    g = pool.ordered_regions[0]
    copies = [_host_words(pool.mns[m].regions[g]) for m in pool.placement[g]]
    assert all(np.array_equal(copies[0], c) for c in copies[1:]), \
        "the keydir replicas differ"
    return {"results": sorted(status.items()), "acked": len(acked),
            "keydir": len(kset), "dropped": len(missing), "drops": drops,
            "scans_ok": ok, "scans_exact": exact,
            "not_found": status.get(("scan", "NOT_FOUND"), 0)}


def ycsbe_small_run(M, cfg, *, n_clients: int, n_keys: int,
                    ops_per_client: int, seed: int = 0,
                    sparse_fences: bool = False, **kw):
    """``chip_smoke.py``'s YCSB-E phase at a small size on either package
    (``kw`` goes to ``FuseeCluster``): a closed-loop load in hashed key
    order, then YCSB-E, both at 4 ops in flight per client, audited by
    ``ycsbe_audit``.  With ``sparse_fences`` every client's fence cache is
    cut to the head leaf between the two, so locates must move right along
    the whole chain.  Returns (audit, results), the cluster and its
    fleet."""
    cl = M.FuseeCluster(cfg, num_clients=n_clients, seed=seed, **kw)
    fleet = cl.fleet()
    backends = [cl.store(c, max_inflight=0).backend
                for c in range(n_clients)]
    values = {}

    def insert(key):
        values[key] = [key, len(values)]
        return M.Op.insert(key, values[key])

    futs = drive_waves(fleet, backends,
                       ycsbe_load_plans(n_keys, n_clients, seed, insert))
    if sparse_fences:
        for c in cl.clients.values():
            c.ord_fences = {0: 0}
    plans, _ = ycsbe_plans(M, cl.rng.stream("workload"), n_keys, n_clients,
                           ops_per_client, insert)
    futs += drive_waves(fleet, backends, plans)
    audit = ycsbe_audit(M, cl, n_keys, values, futs)
    return (audit, [(f.result().status, f.result().value)
                    for f in futs]), cl, fleet
