"""Every case of tests/test_linearize.py on both checkers: the JAX
package's ``repro.core.linearize`` and the port's
``repro_torch.core.linearize``.

Each case runs once per package (``M``) and must reach the verdict the
reference test pins, so the two checkers agree on every history here:
duplicate written values, ABSENT-key transitions (insert-upsert /
update-NOT_FOUND / blind-delete), the non-linearizable counterexamples,
and the ``records_to_hops`` filtering contract.
"""
import types

import pytest

import repro.core.codec as ref_codec
import repro.core.events as ref_events
import repro.core.linearize as ref_lin
import repro.core.sim as ref_sim
import repro_torch.core.codec as port_codec
import repro_torch.core.events as port_events
import repro_torch.core.linearize as port_lin
import repro_torch.core.sim as port_sim

PACKAGES = {
    "repro": types.SimpleNamespace(lin=ref_lin, OpResult=ref_events.OpResult,
                                   OpRecord=ref_sim.OpRecord,
                                   encode_key=ref_codec.encode_key),
    "repro_torch": types.SimpleNamespace(
        lin=port_lin, OpResult=port_events.OpResult,
        OpRecord=port_sim.OpRecord, encode_key=port_codec.encode_key),
}


@pytest.fixture(params=sorted(PACKAGES))
def M(request):
    return PACKAGES[request.param]


def _ins(M, i, inv, resp, v, status="OK"):
    return M.lin.HOp(i, "insert", inv, resp, wrote=v, read=None,
                     status=status)


def _upd(M, i, inv, resp, v, status="OK"):
    return M.lin.HOp(i, "update", inv, resp, wrote=v, read=None,
                     status=status)


def _srch(M, i, inv, resp, v, status="OK"):
    return M.lin.HOp(i, "search", inv, resp, wrote=None, read=v,
                     status=status)


def _del(M, i, inv, resp, status="OK"):
    return M.lin.HOp(i, "delete", inv, resp, wrote=None, read=None,
                     status=status)


# ------------------------------------------------------- duplicate values
def test_duplicate_written_values_sequential(M):
    h = [_ins(M, 0, 0, 1, (7,)), _ins(M, 1, 2, 3, (7,)),
         _srch(M, 2, 4, 5, (7,))]
    assert M.lin.check_linearizable(h)


def test_duplicate_written_values_concurrent_reads_interleave(M):
    h = [_ins(M, 0, 0, 10, (5,)), _ins(M, 1, 0, 10, (5,)),
         _srch(M, 2, 11, 12, (5,)), _srch(M, 3, 13, 14, (5,))]
    assert M.lin.check_linearizable(h)


def test_duplicate_values_do_not_mask_stale_read(M):
    h = [_ins(M, 0, 0, 1, (5,)), _ins(M, 1, 2, 3, (5,)),
         _srch(M, 2, 4, 5, None, status="NOT_FOUND")]
    assert not M.lin.check_linearizable(h)


# --------------------------------------------------- ABSENT transitions
def test_update_on_absent_key_not_found(M):
    assert M.lin.check_linearizable(
        [_upd(M, 0, 0, 1, (9,), status="NOT_FOUND")])


def test_update_on_absent_key_cannot_ack_ok(M):
    assert not M.lin.check_linearizable(
        [_upd(M, 0, 0, 1, (9,), status="OK")])


def test_update_not_found_concurrent_with_insert(M):
    h = [_ins(M, 0, 0, 10, (1,)), _upd(M, 1, 0, 10, (2,),
                                       status="NOT_FOUND")]
    assert M.lin.check_linearizable(h)
    h2 = [_ins(M, 0, 0, 1, (1,)), _upd(M, 1, 2, 3, (2,),
                                       status="NOT_FOUND")]
    assert not M.lin.check_linearizable(h2)


def test_delete_not_found_requires_observed_absence(M):
    assert M.lin.check_linearizable([_del(M, 0, 0, 1, status="NOT_FOUND")])
    h = [_ins(M, 0, 0, 1, (3,)), _del(M, 1, 2, 3, status="NOT_FOUND")]
    assert not M.lin.check_linearizable(h)


def test_delete_ok_is_a_blind_write(M):
    h = [_ins(M, 0, 0, 1, (4,)), _del(M, 1, 2, 8, status="OK"),
         _del(M, 2, 2, 8, status="OK"),
         _srch(M, 3, 9, 10, None, status="NOT_FOUND")]
    assert M.lin.check_linearizable(h)
    assert M.lin.check_linearizable([_del(M, 0, 0, 1, status="OK")])


def test_insert_after_delete_restores_value(M):
    h = [_ins(M, 0, 0, 1, (6,)), _del(M, 1, 2, 3), _ins(M, 2, 4, 5, (7,)),
         _srch(M, 3, 6, 7, (7,))]
    assert M.lin.check_linearizable(h)


# ------------------------------------------- non-linearizable witnesses
def test_counterexample_stale_read_after_overwrite(M):
    h = [_ins(M, 0, 0, 1, (1,)), _ins(M, 1, 2, 3, (2,)),
         _srch(M, 2, 4, 5, (2,)), _srch(M, 3, 6, 7, (1,))]
    assert not M.lin.check_linearizable(h)


def test_counterexample_read_of_never_written_value(M):
    h = [_ins(M, 0, 0, 1, (1,)), _srch(M, 1, 2, 3, (99,))]
    assert not M.lin.check_linearizable(h)


def test_concurrent_reads_may_disagree_on_order(M):
    h = [_ins(M, 0, 0, 1, (1,)), _ins(M, 1, 2, 9, (2,)),
         _srch(M, 2, 3, 9, (2,)), _srch(M, 3, 3, 9, (1,))]
    assert M.lin.check_linearizable(h)


# ------------------------------------------------- records_to_hops -----
def _rec(M, op_id, kind, key, value=None, *, status="OK", rvalue=None,
         result=True, inv=0, resp=1):
    return M.OpRecord(cid=0, op_id=op_id, kind=kind, key=key, value=value,
                      inv_tick=inv, resp_tick=resp,
                      result=M.OpResult(status, value=rvalue)
                      if result else None)


def test_records_to_hops_filters(M):
    recs = [
        _rec(M, 0, "insert", 42, [1, 2]),
        _rec(M, 1, "insert", 43, [3]),
        _rec(M, 2, "search", 42, rvalue=[1, 2]),
        _rec(M, 3, "insert", 42, [9], result=False),
        _rec(M, 4, "scan", 42),
        _rec(M, 5, "insert", 42, [9], status="FULL"),
        _rec(M, 6, "update", 42, [5], status="NOT_FOUND"),
        _rec(M, 7, "delete", 42),
    ]
    hops = sorted(M.lin.records_to_hops(recs, 42), key=lambda o: o.op_id)
    assert [o.op_id for o in hops] == [0, 2, 6, 7]
    assert hops[0].wrote == (1, 2)
    assert hops[1].kind == "search" and hops[1].read == (1, 2)
    assert hops[2].status == "NOT_FOUND"
    assert hops[3].kind == "delete" and hops[3].wrote is None
    assert M.lin.check_linearizable(hops)


def test_records_to_hops_encodes_public_keys(M):
    ik = M.encode_key(b"user:7")
    assert ik == ref_codec.encode_key(b"user:7")
    recs = [_rec(M, 0, "insert", ik, [8]), _rec(M, 1, "insert", 999, [9])]
    hops = M.lin.records_to_hops(recs, b"user:7")
    assert [o.op_id for o in hops] == [0]
    recs2 = [_rec(M, 0, "search", ik, status="NOT_FOUND")]
    (h,) = M.lin.records_to_hops(recs2, b"user:7")
    assert h.read is None and h.status == "NOT_FOUND"
