"""A tiny CPU run of the harness's loop (run.py's path without the card)
prints a last line of the contract's shape; run.py itself refuses to run
without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as T  # noqa: E402

ROOT = T.ROOT


def test_untraced_run_gives_the_end_to_end_metrics():
    res = T.run(T.cell())
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 4
    assert sorted(line["metrics"]) == sorted(
        ["out_tokens_per_s", "ttft_p90_ms", "itl_p95_ms", "setup_s"])
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for k, c in line["checks"].items():
        assert c["value"] <= c["limit"], k
    assert set(line["checks"]) == {
        "prefix_hits_wrong", "acks_missing", "pages_lost", "pages_shared",
        "replica_slots_diverged", "requests_wrong_length", "logit_gap"}


def test_traced_run_gives_the_span_metrics():
    res = T.run(T.cell(), traced=True, seconds=4.0)
    assert res["correct"] is True
    got = res["metrics"]
    # the CPU has no device timeline: its readers return nothing
    for name in ("engine_host_ms_per_step", "pool_admit_ms",
                 "prefill_mfu", "decode_mfu"):
        assert got[name]["value"] > 0
    assert got["prefill_tokens_per_prompt_token"]["value"] == 1.0
    for name in ("device_idle_share", "flash_attention_roofline",
                 "paged_attention_roofline"):
        assert name not in got


def test_open_loop_serves_its_bursts():
    res = T.run(T.cell(loop="open", rate_per_s=4.0, burst=2), seconds=2.0)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 16      # 8 bursts of 2 in 2 s


def test_same_seed_same_requests():
    from perfbench.traffic import Traffic
    mix = T.cell().traffic
    a, b = Traffic(mix, 300, 2 ** 33 + 1), Traffic(mix, 300, 2 ** 33 + 1)
    for key in ((0, 0), (3, 5), (1,)):
        pa, na = a.request(*key)
        pb, nb = b.request(*key)
        assert (pa == pb).all() and na == nb
    c = Traffic(mix, 300, 2 ** 33 + 2)
    assert not (c.request(0, 0)[0] == a.request(0, 0)[0]).all()
    assert (c.request(0, 0)[0][:128] != a.request(0, 0)[0][:128]).any()
    assert (a.request(0, 0)[0][:128] == a.request(2, 1)[0][:128]).all()


def test_sample_takes_a_request_of_each_slot_in_turn():
    from types import SimpleNamespace
    from perfbench.traffic import Traffic
    done = [SimpleNamespace(rid=i, slot=i % 16) for i in range(64)]
    for seed in (1, 2 ** 31 + 9, 2 ** 33 + 5):
        mix = Traffic(T.cell().traffic, 300, seed)
        got = mix.sample(done, 8)
        assert len({r.slot for r in got}) == 8
        assert got == mix.sample(done, 8)          # drawn from the seed
        got = mix.sample(done, 20)
        assert sorted(r.slot for r in got[:16]) == list(range(16))
    picks = {tuple(r.rid for r in Traffic(T.cell().traffic, 300, s)
                   .sample(done, 8)) for s in range(6)}
    assert len(picks) > 1


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_py_refuses_without_a_card(trace):
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", "qwen3-32b.shared-prefix", "--seed",
                        "4294967311", "--seconds", "1", "--trace", trace],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
