"""The port's protocol lint against the JAX package's: the fixtures of
tests/test_analysis.py's ``test_lint_*`` cases through both packages'
``lint_source`` (equal ``(rule, line)`` findings, each the reference's
verdict), the port's own repo-clean case over its default paths, and the
port's analysis modules importing neither JAX nor the JAX package."""
import ast
import os

import pytest

import repro.analysis.lint as ref_lint
import repro_torch
import repro_torch.analysis.lint as port_lint

# (id, source, path, rel, rules, expected rules in finding order)
_L001 = ("def f(pool, v):\n"
         "    return pool.cas(v.region, v.replica, v.off, v.exp, v.new)\n")
_L001_GUARDED = ("def f(pool, v):\n"
                 "    if v.epoch != pool.epoch:\n"
                 "        return None\n"
                 "    return pool.cas(v.region, v.replica, v.off, v.exp, "
                 "v.new)\n")
_L002_ARGLESS = ("import numpy as np\n"
                 "def f():\n"
                 "    return np.random.default_rng()\n")
_L002_DRAW = ("import numpy as np\n"
              "def f():\n"
              "    return np.random.rand()\n")
_L002_SEEDED = ("import numpy as np\n"
                "def f(seed):\n"
                "    return np.random.default_rng(seed)\n")
_L002_KEYED = ("import numpy as np\n"
               "def f(rng: 'np.random.Generator', key):\n"
               "    import jax\n"
               "    return jax.random.split(key)\n")
_L003 = ("def f(pool, g):\n"
         "    mem = pool.mns[0].regions[g]\n"
         "    mem[3] = 1\n")
_L003_READS = ("def f(pool, g):\n"
               "    mem = pool.mns[0].regions[g]\n"
               "    return int(mem[3])\n")
_L004 = ("def tick(self, pool, verbs):\n"
         "    for v in verbs:\n"
         "        pool.read(v.region, v.replica, v.off, v.n)\n")
_L007 = ("def _fused_read_sweep(self, regions):\n"
         "    for r in regions:\n"
         "        pass\n")
_L007_OK = ("def _fused_read_sweep(self, regions):\n"
            "    for r in regions:  # lint: allow-fused-loop (unpack at the"
            " API boundary)\n"
            "        pass\n")
_L005 = "def f(x):\n    assert x > 0\n"
_PRAGMA_LINE = ("def f(x):\n"
                "    assert x > 0  # lint: allow-assert (internal "
                "invariant)\n")
_PRAGMA_DEF = ("def f(x):  # lint: allow-assert (whole body exempt)\n"
               "    assert x > 0\n"
               "    assert x < 9\n")
_PRAGMA_TYPO = "def f(x):\n    assert x  # lint: allow-asert (typo)\n"
_L006_BARE = ("def f(x):\n"
              "    assert x > 0  # lint: allow-assert\n")
_L006_STALE = ("def f(x):\n"
               "    return x  # lint: allow-assert (left over from a "
               "refactor)\n")
_L006_OK = ("def f(x):\n"
            "    assert x > 0  # lint: allow-assert (documented invariant)\n")
_L006_IN_STR = ('MSG = "add `# lint: allow-assert (<why>)`"\n'
                "def f(x):\n"
                "    assert x > 0\n")
_L008 = ("def f(self):\n"
         "    self.counters['ops'] += 1\n"
         "    self.counters = {}\n")
_L009 = ("def flush(self, rows):\n"
         "    for r in rows:\n"
         "        pass\n")

CASES = [
    ("L001", _L001, "sim.py", "core/sim.py", None, ["L001"]),
    ("L001-guarded", _L001_GUARDED, "sim.py", "core/sim.py", None, []),
    ("L001-master", _L001, "master.py", "core/master.py", None, []),
    ("L002-argless", _L002_ARGLESS, "x.py", "core/x.py", None, ["L002"]),
    ("L002-rng", _L002_ARGLESS, "rng.py", "core/rng.py", None, []),
    ("L002-draw", _L002_DRAW, "x.py", "core/x.py", None, ["L002"]),
    ("L002-seeded", _L002_SEEDED, "x.py", "core/x.py", None, []),
    ("L002-keyed", _L002_KEYED, "x.py", "core/x.py", None, []),
    ("L003", _L003, "x.py", "core/x.py", None, ["L003"]),
    ("L003-heap", _L003, "heap.py", "core/heap.py", None, []),
    ("L003-reads", _L003_READS, "x.py", "core/x.py", None, []),
    ("L004", _L004, "fleet.py", "core/fleet.py", {"L004"}, ["L004"]),
    ("L004-client", _L004, "client.py", "core/client.py", {"L004"}, []),
    ("L007", _L007, "heap.py", "core/heap.py", {"L007"}, ["L007"]),
    ("L007-batch", _L007.replace("_fused_read_sweep", "read_batch"),
     "heap.py", "core/heap.py", {"L007"}, []),
    ("L007-client", _L007, "client.py", "core/client.py", {"L007"}, []),
    ("L007-pragma", _L007_OK, "heap.py", "core/heap.py", {"L006", "L007"},
     []),
    ("L005", _L005, "client.py", "core/client.py", None, ["L005"]),
    ("L005-bench", _L005, "run.py", "benchmarks/run.py", None, []),
    ("pragma-line", _PRAGMA_LINE, "c.py", "core/c.py", None, []),
    ("pragma-def", _PRAGMA_DEF, "c.py", "core/c.py", None, []),
    ("pragma-typo", _PRAGMA_TYPO, "c.py", "core/c.py", None,
     ["E001", "L005"]),
    ("L006-bare", _L006_BARE, "c.py", "core/c.py", None, ["L006"]),
    ("L006-stale", _L006_STALE, "c.py", "core/c.py", None, ["L006"]),
    ("L006-ok", _L006_OK, "c.py", "core/c.py", None, []),
    ("L006-in-string", _L006_IN_STR, "c.py", "core/c.py", None, ["L005"]),
    ("L008", _L008, "client.py", "core/client.py", None, ["L008", "L008"]),
    ("L008-bench", _L008, "run.py", "benchmarks/run.py", None, []),
    ("L009", _L009, "flight.py", "obs/flight.py", None, ["L009"]),
    ("L009-cold", _L009.replace("flush", "describe"), "flight.py",
     "obs/flight.py", None, []),
]


@pytest.mark.parametrize("src,path,rel,rules,want",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_lint_fixture_matches_reference(src, path, rel, rules, want):
    got = {}
    for name, lint in (("ref", ref_lint), ("port", port_lint)):
        found = lint.lint_source(src, path, rel=rel, rules=rules)
        got[name] = [(f.rule, f.line) for f in found]
        assert sorted(f.rule for f in found) == sorted(want), (name, found)
    assert got["port"] == got["ref"]


def test_lint_messages_name_the_ports_registry():
    found = port_lint.lint_source(_L008, "client.py", rel="core/client.py")
    assert found and all("repro_torch.obs.registry" in f.msg for f in found)
    found = port_lint.lint_source(_L006_STALE, "c.py", rel="core/c.py")
    assert "stale" in found[0].msg


def test_lint_repo_is_clean():
    paths = port_lint.default_paths()
    assert os.path.samefile(paths[0], os.path.dirname(repro_torch.__file__))
    assert [os.path.basename(p) for p in paths[1:]] \
        == ["tests", "benchmarks"]
    assert port_lint.lint_paths(paths) == []
    assert port_lint.main([]) == 0


def test_lint_cli_reports_findings(tmp_path, capsys):
    bad = tmp_path / "core" / "x.py"
    bad.parent.mkdir()
    bad.write_text(_L005)
    assert port_lint.main([str(tmp_path)]) == 1
    assert "L005" in capsys.readouterr().out
    assert port_lint.main([str(tmp_path), "--rules", "L002"]) == 0


def _imported_roots(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_modules_import_neither_jax_nor_the_reference():
    pkg = os.path.dirname(repro_torch.__file__)
    seen = []
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                assert not _imported_roots(path) & {"jax", "repro"}, path
                seen.append(os.path.relpath(path, pkg))
    assert {"analysis/explore.py", "analysis/lint.py"} <= set(seen)
