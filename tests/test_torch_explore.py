"""The port's DPOR model checker against the JAX package's, on the CPU:
every case of tests/test_explore.py on both packages, tolerance 0.

Each case runs the same scope, bounds and flags through
``repro.analysis.explore`` and ``repro_torch.analysis.explore`` (the port's
cluster on ``device="cpu"``) and requires equal state and execution
counts, visit digests, ``complete`` flags, violation kinds and minimized
schedules, and equal ``check_invariants`` verdicts on the fixed schedules.
Counterexamples cross packages as ``.npz`` files of plain numpy arrays:
what one package saves, the other loads and reproduces.  The scopes
pipeline two ops on one client, so the reference client carries ROADMAP
C1's fix (``ref_c1_fixed``), as the port does.

``test_seed7_cutover_cold_start_find_and_minimize`` (the flagged cutover
scope explored from its initial state, several minutes on the reference
alone) has no twin here; ``test_seed7_prefix_cold_start_find_and_minimize``
stands beside it: the cutover scope entered after the first
``SEED7_PREFIX`` choices of the seed-7 schedule, explored cold and
minimized on both packages.
"""
import numpy as np
import pytest
import torch

import repro.analysis.explore as ref_explore
import repro.core.client as ref_client
import repro.core.master as ref_master
import repro.core.sim as ref_sim
import repro_torch.analysis.explore as port_explore
import repro_torch.core.client as port_client
import repro_torch.core.master as port_master
import repro_torch.core.sim as port_sim

from _torch_parity import choice_rows, explore_signature, ref_c1_fixed
from test_explore import LOSER_RESET_MIN_SCHEDULE, SEED7_MIN_SCHEDULE

pytestmark = pytest.mark.usefixtures("ref_c1_fixed")

# (explore module, sim module, keyword arguments of a build / run)
PKGS = {"ref": (ref_explore, ref_sim, {}),
        "port": (port_explore, port_sim, {"device": "cpu"})}
FLAG_MODS = {"client": (ref_client, port_client),
             "master": (ref_master, port_master)}

# the cutover scope entered this deep into SEED7_MIN_SCHEDULE: the cold
# search then needs the add_mn boundary, and finds and minimizes the
# acknowledged-write loss in a few seconds on either package (one choice
# shallower takes minutes)
SEED7_PREFIX = 10


def _both(fn):
    """``fn(explore_module, sim_module, kw)`` on both packages."""
    return [fn(E, S, kw) for E, S, kw in PKGS.values()]


def _as(sim_mod, schedule):
    return [sim_mod.Choice(c.kind, cid=c.cid, mn=c.mn, name=c.name)
            for c in schedule]


def _fire_schedule(E, S, kw, scope_name, schedule):
    setup = E.SCOPES[scope_name].build(**kw)
    for ch in _as(S, schedule):
        setup.cluster.fire(ch)
    n = 0
    while n < 10_000:
        cs = setup.cluster.choices()
        if not cs:
            return setup
        setup.cluster.fire(cs[0])
        n += 1
    raise AssertionError("leftmost continuation did not drain")


def _verdict(E, setup):
    """``check_invariants`` and the final state's digest."""
    return ([(v.kind, v.detail) for v in E.check_invariants(setup)],
            E.state_hash(setup.cluster))


def _set_flag(monkeypatch, spec: str):
    mod, attr = spec.split(".")
    for m in FLAG_MODS[mod]:
        monkeypatch.setattr(m, attr, True)


def _same(results):
    ref, port = (explore_signature(r) for r in results)
    assert ref == port, (ref, port)
    return ref


# ------------------------------------------------------------ scope registry
def test_scopes_build_and_enumerate_same_choices():
    assert sorted(ref_explore.SCOPES) == sorted(port_explore.SCOPES)
    for name in ref_explore.SCOPES:
        ref, port = _both(lambda E, S, kw: E.SCOPES[name].build(**kw))
        got = choice_rows(port.cluster.choices())
        assert got, f"scope {name} starts with no choices"
        assert got == choice_rows(ref.cluster.choices()), name
        assert port.keys == ref.keys, name
        assert port_explore.state_hash(port.cluster) \
            == ref_explore.state_hash(ref.cluster), name


# --------------------------------------------------------------- clean scopes
@pytest.mark.parametrize("scope", ["no_fault", "crash", "insert_race"])
def test_clean_scopes_full_depth(scope):
    got = _same(_both(lambda E, S, kw: E.explore(scope, minimize=False,
                                                 **kw)))
    assert got["complete"], scope
    assert not got["violations"], (scope, got)


@pytest.mark.parametrize("scope,bound", [("stale_epoch", 300),
                                         ("cutover", 150),
                                         ("loser_reset", 300)])
def test_clean_scopes_bounded_prefixes(scope, bound):
    got = _same(_both(lambda E, S, kw: E.explore(
        scope, minimize=False, max_states=bound, **kw)))
    assert not got["violations"], (scope, got)
    assert got["states"] >= bound


def test_exploration_is_deterministic():
    a = port_explore.Explorer("no_fault", device="cpu").run()
    b = port_explore.Explorer("no_fault", device="cpu").run()
    assert (a.states, a.executions, a.visit_digest) \
        == (b.states, b.executions, b.visit_digest)
    assert a.visit_digest
    ref = ref_explore.Explorer("no_fault").run()
    assert explore_signature(a) == explore_signature(ref)


def test_naive_mode_agrees_on_clean_scope():
    naive = _same(_both(lambda E, S, kw: E.Explorer(
        "no_fault", naive=True, **kw).run()))
    dpor = port_explore.Explorer("no_fault", device="cpu").run()
    assert not naive["violations"]
    assert naive["states"] >= dpor.states


# ------------------------------------------------- known holes, rediscovered
def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("scope,flag,max_states", [
    ("lost_ack", "client.UNSAFE_ACK_LOST_EMPTY_CAS", 200_000),
    ("stale_epoch", "sim.UNSAFE_EXEC_STALE_EPOCH", 2000)])
def test_explorer_rediscovers_and_replays_across_packages(
        tmp_path, scope, flag, max_states):
    flags = {flag: True}
    runs = _both(lambda E, S, kw: E.explore(scope, flags=flags,
                                            max_states=max_states, **kw))
    got = _same(runs)
    assert got["violations"], got
    kinds = [k for k, _ in got["violations"]]
    if scope == "lost_ack":
        assert kinds[0] in ("acked_write_lost", "linearizability")
    for _, minimized in got["violations"]:
        assert 0 < len(minimized) <= 25
    paths = {}
    for (name, (E, S, kw)), res in zip(PKGS.items(), runs):
        v = res.violations[0]
        paths[name] = str(tmp_path / f"{scope}-{name}.npz")
        E.save_counterexample(paths[name], scope, v, flags=flags)
        scope_name, kind, _, sched, loaded = \
            E.load_counterexample(paths[name])
        assert (scope_name, kind, loaded) == (scope, v.kind, flags)
        assert sched == tuple(v.minimized)
    ref_z, port_z = _npz_arrays(paths["ref"]), _npz_arrays(paths["port"])
    assert sorted(ref_z) == sorted(port_z)
    for k in ref_z:
        assert ref_z[k].dtype != object
        np.testing.assert_array_equal(ref_z[k], port_z[k], err_msg=k)
    # what one package saved, the other reproduces
    for loader, path, kw in ((ref_explore, paths["port"], {}),
                             (port_explore, paths["ref"], {"device": "cpu"})):
        lines = []
        assert loader.replay(path, out=lines.append, **kw)
        assert any(f"VIOLATION {kinds[0]}" in ln for ln in lines), lines


# ------------------------------------------------------ seed-7 churn cutover
def test_seed7_cutover_schedule_is_clean_with_fix():
    ref, port = _both(lambda E, S, kw: _verdict(E, _fire_schedule(
        E, S, kw, "cutover", SEED7_MIN_SCHEDULE)))
    assert port == ref
    assert port[0] == []


def test_seed7_cutover_schedule_violates_with_fix_reverted(monkeypatch):
    _set_flag(monkeypatch, "client.UNSAFE_FREE_OWN_ON_RETRY")
    ref, port = _both(lambda E, S, kw: _verdict(E, _fire_schedule(
        E, S, kw, "cutover", SEED7_MIN_SCHEDULE)))
    assert port == ref
    assert "acked_write_lost" in {k for k, _ in port[0]}, port[0]


def _seed7_prefix_scope(E, S):
    prefix = _as(S, SEED7_MIN_SCHEDULE[:SEED7_PREFIX])

    def build(**kw):
        setup = E.SCOPES["cutover"].build(**kw)
        for ch in prefix:
            assert setup.cluster.fire(ch), ch
        return setup
    return E.Scope(f"cutover@seed7[:{SEED7_PREFIX}]",
                   "the cutover scope after a seed-7 prefix", build)


def _cold_start(E, S, kw, scope, flags, kind):
    ex = E.Explorer(scope, flags=flags, **kw)
    res = ex.run()
    assert kind in {v.kind for v in res.violations}, res.summary()
    ex.minimize(next(x for x in res.violations if x.kind == kind))
    return res


def test_seed7_prefix_cold_start_find_and_minimize():
    # beside test_explore.py's full cold start, which has no twin here
    got = _same(_both(lambda E, S, kw: _cold_start(
        E, S, kw, _seed7_prefix_scope(E, S),
        {"client.UNSAFE_FREE_OWN_ON_RETRY": True}, "acked_write_lost")))
    minimized = dict(got["violations"])["acked_write_lost"]
    assert 0 < len(minimized) <= 25
    # the search had to place the membership bump itself
    assert ("event", -1, -1, "add_mn") in minimized


# -------------------------------------------------- seeds-8/15 torn redo
def test_loser_reset_schedule_is_clean_with_fix():
    ref, port = _both(lambda E, S, kw: _verdict(E, _fire_schedule(
        E, S, kw, "loser_reset", LOSER_RESET_MIN_SCHEDULE)))
    assert port == ref
    assert port[0] == []


def test_loser_reset_schedule_violates_with_fix_reverted(monkeypatch):
    _set_flag(monkeypatch, "master.UNSAFE_REDO_NO_CONVERGE")
    ref, port = _both(lambda E, S, kw: _verdict(E, _fire_schedule(
        E, S, kw, "loser_reset", LOSER_RESET_MIN_SCHEDULE)))
    assert port == ref
    assert "heap_audit" in {k for k, _ in port[0]}, port[0]


def test_loser_reset_cold_start_find_and_minimize():
    got = _same(_both(lambda E, S, kw: _cold_start(
        E, S, kw, "loser_reset", {"master.UNSAFE_REDO_NO_CONVERGE": True},
        "heap_audit")))
    assert 0 < len(dict(got["violations"])["heap_audit"]) <= 25


# ------------------------------------------------------------------ CLI
def test_cli_list():
    assert port_explore.main(["--list"]) == 0


def test_cli_explore_save_and_repro(tmp_path, capsys):
    assert port_explore.main(["--scope", "crash", "--device", "cpu"]) == 0
    out = {}
    for name, E, extra in (("ref", ref_explore, []),
                           ("port", port_explore, ["--device", "cpu"])):
        d = tmp_path / name
        assert E.main(["--scope", "lost_ack", "--unsafe",
                       "client.UNSAFE_ACK_LOST_EMPTY_CAS", "--out", str(d)]
                      + extra) == 1
        out[name] = sorted(p.name for p in d.iterdir())
        assert out[name]
    assert out["port"] == out["ref"]
    for fn in out["port"]:
        ref_z = _npz_arrays(tmp_path / "ref" / fn)
        port_z = _npz_arrays(tmp_path / "port" / fn)
        for k in ref_z:
            np.testing.assert_array_equal(ref_z[k], port_z[k], err_msg=k)
        assert port_explore.main(["--repro", str(tmp_path / "ref" / fn),
                                  "--device", "cpu"]) == 1
    assert "[device cpu]" in capsys.readouterr().out


def test_entry_points_default_to_the_card(tmp_path):
    path = str(tmp_path / "ce.npz")
    v = port_explore.Violation("heap_audit", "", ())
    port_explore.save_counterexample(path, "crash", v)
    if torch.cuda.is_available():
        assert port_explore.Explorer("crash").device.type == "cuda"
        assert port_explore.SCOPES["crash"].build().cluster.device.type \
            == "cuda"
        return
    for call in (lambda: port_explore.Explorer("crash"),
                 lambda: port_explore.explore("crash"),
                 lambda: port_explore.SCOPES["crash"].build(),
                 lambda: port_explore.replay(path, out=lambda s: None),
                 lambda: port_explore.main(["--scope", "crash"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
