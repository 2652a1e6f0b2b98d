"""BENCHMARK.json against the contract's shape, every name it holds
resolving to its files, and the import guard: nothing under perfbench/
imports JAX or the JAX package, and the reference imports nothing of the
program."""
import ast
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert sorted(BENCH) == sorted(["command", "paths", "run_seconds",
                                    "configs", "workloads", "end_to_end",
                                    "per_layer"])
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert sorted(c) == ["file", "name", "reduced", "source", "why"]
    for w in BENCH["workloads"]:
        assert sorted(w) == ["chips", "config", "name", "traffic", "why"]
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]]
    texts += [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert LINE.match(t), t


def test_metrics_point_at_reported_end_to_end_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}[
        "setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_files_by_name(cell):
    c = spec.cell(cell, BENCH, ROOT)
    assert c.config["num_hidden_layers"] > 0
    assert c.traffic["loop"] in ("closed", "open")
    assert c.limits["logit_gap"] > 0
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    conf = {x["name"]: x for x in BENCH["configs"]}[c.config_name]
    assert sorted(conf["reduced"]) == sorted(c.config["reduced"])
    assert c.config["source"] == conf["source"]


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("perfbench/") and (ROOT / f).is_file()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted((ROOT / "perfbench").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not bad, f"{path} imports {bad}"
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        assert "repro_torch" not in _imports(path)


def test_guard_compares_whole_top_level_names():
    from perfbench import run
    assert run.loaded_forbidden(["repro_torch", "repro_torch.serving",
                                 "torch", "jaxtyping"]) == []
    assert run.loaded_forbidden(["repro_torch", "repro.core"]) == ["repro"]
    assert run.loaded_forbidden(["jax.numpy", "flax"]) == ["flax", "jax"]
