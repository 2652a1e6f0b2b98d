"""The comparison fails a run whose timed path is broken underneath: the
harness runs the tiny CPU cell with each fault planted after set-up and
must print ``correct`` false; the sound run prints true.  A serving cell
on one card can have these faults: a token altered where it is produced,
a decode step that leaves its cache's state as it was, half of the batch
left out (its rows served another row's prompt), a pool that answers a
stored key as missing, and an insert acknowledged but never written.
There is no exchange between cards to leave out."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as T  # noqa: E402


def token_altered(engine, model):
    emit = engine._emit

    def bad(logits):
        emit(logits)
        for req in engine.active.values():
            if len(req.out) == 1:
                req.out[0] = (req.out[0] + 1) % 300
    engine._emit = bad


def state_unchanged(engine, model):
    step = model.decode_step

    def bad(params, cache, token):
        n = cache["length"]
        logits, cache = step(params, cache, token)
        cache["length"] = n
        return logits, cache
    model.decode_step = bad


def half_batch_left_out(engine, model):
    prefill = model.prefill

    def bad(params, toks, **kw):
        toks = toks.clone()
        half = toks.shape[0] // 2
        toks[half:2 * half] = toks[:half]
        return prefill(params, toks, **kw)
    model.prefill = bad


def hits_answered_missing(engine, model):
    search = engine.pool.search

    def bad(keys):
        ptr, found = search(keys)
        return ptr, np.zeros_like(found)
    engine.pool.search = bad


def insert_never_written(engine, model):
    def bad(cid, keys, pages, opcode=1):
        return np.ones(len(keys), bool)
    engine.pool.insert_batch = bad


# each fault, and the comparison that must catch it
FAULTS = {"token_altered": (token_altered, "logit_gap"),
          "state_unchanged": (state_unchanged, "logit_gap"),
          "half_batch_left_out": (half_batch_left_out, "logit_gap"),
          "hits_answered_missing": (hits_answered_missing,
                                    "prefix_hits_wrong"),
          "insert_never_written": (insert_never_written, "pages_lost")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    plant, caught_by = FAULTS[fault]
    res = T.run(T.cell(new_tokens=6), faults=plant)
    checks = res["checks"]
    assert checks["logit_gap"]["value"] < float("inf"), "nothing finished"
    assert checks[caught_by]["value"] > checks[caught_by]["limit"], checks
    assert res["correct"] is False


def decode_long_ratio() -> dict:
    """The decode-long cell's slots and sampled requests, and as many
    clients as slots, as its mix file gives them."""
    mix = T.spec.load_json(T.ROOT / "perfbench" / "traffic" /
                           "decode-long.json")
    return {"clients": mix["max_batch"], "max_batch": mix["max_batch"],
            "check_requests": mix["check_requests"]}


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 32 + 13])
def test_half_batch_left_out_at_the_cells_ratio_of_sample_to_batch(seed):
    res = T.run(T.cell(new_tokens=4, **decode_long_ratio()), seed=seed,
                faults=half_batch_left_out)
    checks = res["checks"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"], \
        checks
    assert res["correct"] is False


def test_the_sound_path_is_correct():
    res = T.run(T.cell(new_tokens=6))
    assert res["correct"] is True, res["checks"]
