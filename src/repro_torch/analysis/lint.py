"""AST protocol lints for the FUSEE reproduction (L001-L009).

Run as ``python -m repro_torch.analysis.lint [paths...]`` (defaults to
the ``repro_torch`` package plus the repo's ``tests/`` and ``benchmarks/``
trees); exits nonzero on any finding, which is what the CI ``analysis`` job
enforces.  Rules encode protocol contracts that type checkers cannot
see:

L001  **epoch-threaded verbs** — a direct ``pool.read/write/cas/faa``
      (or ``*_batch``) call site must sit in a function that compares a
      lease ``epoch`` (the §5.2 stale-verb guard), unless the module runs
      under master authority (``master.py``, ``migrate.py``, ``heap.py``
      itself).  The stale-epoch redirection bug class: a verb that
      executes against re-homed placement without an issue-time epoch
      check.
L002  **nondeterminism** — ``random.*``, ``time.time()``, and global
      ``np.random.*`` draws are banned outside ``core/rng.py``: every
      random decision must derive from a named ``SimRng`` substream or
      an explicit seed, or the replay contract breaks.  Seed-taking
      constructors (``default_rng(seed)``, ``SeedSequence(seed)``,
      ``random.Random(seed)``) called WITH arguments are deterministic
      functions of their inputs and exempt; the argless forms draw OS
      entropy and are flagged.  (Explicitly-keyed ``jax.random`` and
      ``torch`` draws are not matched.)
L003  **pool-array mutation** — only ``DMPool`` (and the master-authority
      modules) may store into MN region arrays (``*.regions[...]`` or
      names derived from them).  Everyone else goes through verbs, which
      the tracer, netmodel, and crash-stop logic can see.
L004  **scalar loops in batch paths** — ``fleet.py`` functions and
      ``heap.py`` ``*_batch`` methods must not issue scalar verbs from a
      Python ``for``/``while`` (the fleet tick's whole point is one array
      call per verb kind; a per-client loop silently reverts to O(N)
      Python).
L005  **bare assert in protocol code** — ``core/*.py`` must raise typed
      ``faults`` errors carrying reproducing context instead of ``assert``
      (asserts vanish under ``python -O`` and carry no seed/cid/tick).
L006  **pragma hygiene** — every suppression pragma must carry a
      parenthesized justification, and must actually suppress a finding:
      a pragma whose rule no longer fires on its line is *stale* and gets
      reported (a leftover license would silently cover a future
      regression on that line).
L007  **Python loops in the fused tick path** — ``*fused*`` functions in
      ``fleet.py``/``heap.py`` are the megakernel: one array dispatch
      over the whole fleet's lanes.  Any statement-level ``for``/
      ``while`` there is a per-lane O(N) regression waiting to scale, so
      each one must either vanish into array ops or carry an explicit
      ``allow-fused-loop`` pragma arguing why it is not per-lane work
      (LUT rebuilds on topology changes, per-verb result unpack at the
      generator API boundary, inherently sequential same-word races).
L008  **bare counters-dict mutation** — protocol/fleet code must not
      write through ad-hoc ``counters`` dicts (``self.counters[k] += 1``
      or rebinding ``.counters`` to a dict literal): metrics live in the
      typed registry (``repro_torch.obs.registry``) under stable dotted
      names, where snapshots are deterministic, mergeable, and covered by
      the fused-vs-oracle differential gate.  The surviving ``counters``
      attributes are read-only deprecation views.
L009  **Python loops in obs hot paths** — the observability package's
      cost contract (obs/flight.py docstring, claims-checked by the
      ``obs_overhead`` bench) is tuple-append per op and array passes per
      flush.  A statement-level ``for``/``while`` inside an ``obs/``
      flush/update/observe/fold/build-family function is a per-element
      regression waiting to scale exactly like L004/L007; vectorize it,
      or carry an ``allow-obs-loop`` pragma arguing why the loop is not
      per-element work (taxonomy-bounded group walks, export paths).

Suppression: a trailing ``# lint: allow-<name> (<why>)`` pragma on the
offending line, or on the enclosing ``def``/``class`` line to cover the
whole body.  ``<name>`` is the rule id (``L003``) or its alias:
``assert`` (L005), ``epoch`` (L001), ``nondet`` (L002), ``pool-mutation``
(L003), ``scalar-loop`` (L004), ``fused-loop`` (L007), ``counters``
(L008), ``obs-loop`` (L009).  Pragmas are deliberate, documented
exemptions — the lint keeps them honest by flagging unknown names,
missing justifications, and stale sites (L006 itself is exempt from
suppression: delete the pragma instead).

Counterpart of the JAX package's ``analysis/lint.py``, rule for rule, with
the same scoping and pragma grammar: ``rel`` is the path relative to the
package root, so ``core/heap.py``, ``fleet.py`` and ``obs/`` scope the same
way in either package.  Pure ``ast``; it imports neither package.
"""
from __future__ import annotations

import argparse
import ast
import io
import os
import re
import sys
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_source", "lint_paths", "main", "RULES"]

RULES = {
    "L001": "verb site lacks a lease-epoch guard",
    "L002": "nondeterministic source outside core/rng.py",
    "L003": "direct mutation of pool region arrays outside DMPool",
    "L004": "scalar verb loop inside a batch path",
    "L005": "bare assert in protocol code",
    "L006": "lint pragma without justification, or stale (suppresses "
            "nothing)",
    "L007": "Python loop inside a fused tick path",
    "L008": "write through a bare counters dict in protocol code",
    "L009": "Python loop inside an obs hot path",
}

_ALIASES = {
    "epoch": "L001", "nondet": "L002", "pool-mutation": "L003",
    "scalar-loop": "L004", "assert": "L005", "fused-loop": "L007",
    "counters": "L008", "obs-loop": "L009",
}

# L009 scope: function-name prefixes (leading underscores stripped) of
# the obs/ batch entry points — per-flush / per-wave code where a
# per-element Python loop silently reverts the vectorized cost contract
_OBS_HOT_PREFIXES = (
    "flush", "update", "observe", "touch", "heat", "push", "emit",
    "fold", "build", "evaluate", "top", "group", "critical",
    "spans_to", "op_begin", "op_settled", "append")

VERBS = ("read", "write", "cas", "faa")

# RNG constructors that take an explicit seed: called WITH arguments they
# are deterministic functions of their inputs and replay-safe; only the
# argless forms (OS entropy) and module-level draws are nondeterministic
_SEEDED_CTORS = ("np.random.default_rng", "numpy.random.default_rng",
                 "np.random.SeedSequence", "numpy.random.SeedSequence",
                 "random.Random")
BATCH_VERBS = tuple(v + "_batch" for v in VERBS)

# modules that legitimately run under master authority (recovery,
# migration, the pool itself): direct array/verb access is their job
MASTER_AUTHORITY = {"master.py", "migrate.py", "heap.py"}

_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow-([A-Za-z0-9_-]+)(?:\s*\(([^)]*)\))?")


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


# ------------------------------------------------------------------ helpers
def _dotted(node) -> str:
    """Best-effort dotted name of an expression ('pool.cas', 'np.random')."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _comments(text: str) -> List[Tuple[int, str]]:
    """(line, comment-text) for every real comment token — pragmas are
    comments, and only comments: the pattern appearing inside a string
    literal (a lint message, a test fixture) is not a pragma."""
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        out = list(enumerate(text.splitlines(), 1))   # best effort
    return out


def _pragmas(text: str) -> Dict[int, Set[str]]:
    """line -> set of rule ids allowed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in _comments(text):
        for m in _PRAGMA_RE.finditer(line):
            name = m.group(1)
            rule = _ALIASES.get(name.lower(), name.upper())
            if rule not in RULES:
                out.setdefault(i, set()).add("?" + name)
            else:
                out.setdefault(i, set()).add(rule)
    return out


def _pragma_sites(text: str) -> List[Tuple[int, str, str, str]]:
    """Every pragma occurrence: (line, rule-or-?name, raw name,
    stripped justification text)."""
    out = []
    for i, line in _comments(text):
        for m in _PRAGMA_RE.finditer(line):
            name = m.group(1)
            rule = _ALIASES.get(name.lower(), name.upper())
            if rule not in RULES:
                rule = "?" + name
            out.append((i, rule, name, (m.group(2) or "").strip()))
    return out


def _contains_epoch_compare(fn: ast.AST) -> bool:
    """Does the function body compare anything called ``epoch``?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for part in [node.left] + list(node.comparators):
                for sub in ast.walk(part):
                    name = getattr(sub, "attr", None) or \
                        (sub.id if isinstance(sub, ast.Name) else None)
                    if name and "epoch" in name.lower():
                        return True
    return False


def _names_in_target(target) -> List[str]:
    """Names bound by an assignment/loop target (handles tuple unpack)."""
    out = []
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.append(node.id)
    return out


def _mentions_regions(node) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "regions"
               for n in ast.walk(node))


# ------------------------------------------------------------------- engine
class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, text: str,
                 rules: Set[str]):
        self.path = path
        self.base = os.path.basename(rel)
        self.in_core = f"{os.sep}core{os.sep}" in rel or \
            rel.replace("/", os.sep).startswith(f"core{os.sep}")
        self.in_obs = f"{os.sep}obs{os.sep}" in rel or \
            rel.replace("/", os.sep).startswith(f"obs{os.sep}")
        self.is_rng = rel.replace(os.sep, "/").endswith("core/rng.py")
        self.rules = rules
        self.pragmas = _pragmas(text)
        self.used_pragmas: Set[Tuple[int, str]] = set()
        self.findings: List[LintFinding] = []
        self._fn_stack: List[ast.AST] = []   # enclosing function defs
        self._cls_stack: List[ast.ClassDef] = []
        self._tainted: List[Set[str]] = []   # per-function region-array names

    # ----------------------------------------------------------- reporting
    def _flag(self, rule: str, node: ast.AST, msg: str):
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 0)
        covered = [line] + \
            [f.lineno for f in self._fn_stack] + \
            [c.lineno for c in self._cls_stack]
        for ln in covered:
            if rule in self.pragmas.get(ln, ()):
                self.used_pragmas.add((ln, rule))  # L006 staleness proof
                return
        self.findings.append(
            LintFinding(self.path, line, rule, msg))

    # -------------------------------------------------------------- scopes
    def _visit_fn(self, node):
        self._fn_stack.append(node)
        self._tainted.append(set())
        self.generic_visit(node)
        self._tainted.pop()
        self._fn_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node)

    def visit_ClassDef(self, node):
        self._cls_stack.append(node)
        self.generic_visit(node)
        self._cls_stack.pop()

    # --------------------------------------------------------------- L005
    def visit_Assert(self, node):
        if self.in_core:
            self._flag(
                "L005", node,
                "bare assert in protocol code — raise a typed faults error "
                "(ProtocolViolation / RegionLost / ...) with reproducing "
                "context, or add `# lint: allow-assert (<why>)`")
        self.generic_visit(node)

    # --------------------------------------------------------------- calls
    def visit_Call(self, node):
        name = _dotted(node.func)
        self._check_L001(node, name)
        self._check_L002(node, name)
        self.generic_visit(node)

    def _check_L001(self, node, name):
        if self.base in MASTER_AUTHORITY or not self.in_core:
            return
        last = name.rsplit(".", 1)
        if len(last) != 2 or last[1] not in VERBS + BATCH_VERBS:
            return
        recv = last[0]
        # receivers that are (or hold) the pool — heuristic on naming
        if not (recv in ("pool", "p", "self.pool")
                or recv.endswith(".pool")):
            return
        if self._fn_stack and _contains_epoch_compare(self._fn_stack[-1]):
            return    # the §5.2 guard is present in this function
        self._flag(
            "L001", node,
            f"direct pool verb `{name}(...)` without a lease-epoch guard "
            "in the enclosing function — stale verbs must bounce (§5.2); "
            "compare the issue-time epoch or add "
            "`# lint: allow-epoch (<why>)`")

    def _check_L002(self, node, name):
        if self.is_rng:
            return
        if name in _SEEDED_CTORS and (node.args or node.keywords):
            return    # explicitly seeded: deterministic given its inputs
        bad = None
        if name.startswith(("np.random.", "numpy.random.")):
            bad = f"`{name}`"
        elif name == "time.time":
            bad = "`time.time()` (wall clock)"
        elif name.startswith("random.") and name.count(".") == 1:
            bad = f"stdlib `{name}`"
        if bad:
            self._flag(
                "L002", node,
                f"{bad} breaks seeded replay — draw from a named "
                "core/rng.py SimRng substream, or add "
                "`# lint: allow-nondet (<why>)`")

    # --------------------------------------------------------------- L003
    def visit_Assign(self, node):
        self._check_store_targets(node.targets, node)
        self._check_L008(node.targets, node, rebind=True)
        if self._tainted and _mentions_regions(node.value):
            for t in node.targets:
                self._tainted[-1].update(_names_in_target(t))
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_store_targets([node.target], node)
        self._check_L008([node.target], node, rebind=False)
        self.generic_visit(node)

    def visit_For(self, node):
        if self._tainted and _mentions_regions(node.iter):
            self._tainted[-1].update(_names_in_target(node.target))
        self._check_L004(node)
        self._check_L007(node)
        self._check_L009(node)
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_L004(node)
        self._check_L007(node)
        self._check_L009(node)
        self.generic_visit(node)

    def _check_store_targets(self, targets, node):
        if self.base in MASTER_AUTHORITY or not self.in_core:
            return
        for t in targets:
            if not isinstance(t, ast.Subscript):
                continue
            if _mentions_regions(t.value):
                self._flag(
                    "L003", node,
                    "direct store into an MN region array — only DMPool "
                    "(and master-authority modules) may bypass the verb "
                    "layer; issue verbs, or add "
                    "`# lint: allow-pool-mutation (<why>)`")
            elif isinstance(t.value, ast.Name) and self._tainted \
                    and t.value.id in self._tainted[-1]:
                self._flag(
                    "L003", node,
                    f"store into `{t.value.id}[...]`, which aliases an MN "
                    "region array — only DMPool (and master-authority "
                    "modules) may bypass the verb layer; issue verbs, or "
                    "add `# lint: allow-pool-mutation (<why>)`")

    # --------------------------------------------------------------- L008
    def _check_L008(self, targets, node, *, rebind: bool):
        """Writes through bare ``counters`` dicts in protocol code: the
        typed registry (repro_torch.obs.registry) is the sanctioned metric
        store; the surviving ``counters`` attributes are read-only
        deprecation views."""
        if not self.in_core:
            return
        for t in targets:
            if isinstance(t, ast.Subscript):
                base = _dotted(t.value)
                if base == "counters" or base.endswith(".counters"):
                    self._flag(
                        "L008", node,
                        f"write through `{base}[...]` — metrics belong in "
                        "the typed registry (repro_torch.obs.registry) "
                        "under dotted names, not ad-hoc counters dicts; "
                        "bump a registry handle, or add "
                        "`# lint: allow-counters (<why>)`")
            elif rebind and isinstance(t, ast.Attribute) \
                    and t.attr == "counters" \
                    and isinstance(node.value, (ast.Dict, ast.DictComp)):
                self._flag(
                    "L008", node,
                    "rebinding `.counters` to a dict literal — register "
                    "Counter/Gauge handles on the metrics registry "
                    "(repro_torch.obs.registry) instead, or add "
                    "`# lint: allow-counters (<why>)`")

    # --------------------------------------------------------------- L004
    def _in_batch_scope(self) -> bool:
        if self.base == "fleet.py":
            return True
        if self.base == "heap.py" and self._fn_stack:
            fn = self._fn_stack[-1]
            return getattr(fn, "name", "").endswith("_batch")
        return False

    def _check_L004(self, node):
        if not self._in_batch_scope():
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func)
                last = name.rsplit(".", 1)
                if len(last) == 2 and last[1] in VERBS \
                        and (last[0] in ("pool", "p", "self", "self.pool")
                             or last[0].endswith(".pool")):
                    self._flag(
                        "L004", node,
                        f"scalar verb `{name}(...)` inside a Python "
                        f"{'for' if isinstance(node, ast.For) else 'while'} "
                        "loop on a batch path — use the *_batch twins (one "
                        "array call per verb kind), or add "
                        "`# lint: allow-scalar-loop (<why>)`")
                    return

    # --------------------------------------------------------------- L007
    def _check_L007(self, node):
        if self.base not in ("fleet.py", "heap.py"):
            return
        if not any("fused" in getattr(fn, "name", "")
                   for fn in self._fn_stack):
            return
        kw = "for" if isinstance(node, ast.For) else "while"
        self._flag(
            "L007", node,
            f"Python `{kw}` loop inside a fused tick path — the megakernel "
            "contract is ONE array dispatch over all lanes; vectorize it, "
            "or add `# lint: allow-fused-loop (<why this is not per-lane "
            "work>)`")

    # --------------------------------------------------------------- L009
    def _check_L009(self, node):
        if not self.in_obs or not self._fn_stack:
            return
        name = getattr(self._fn_stack[-1], "name", "").lstrip("_")
        if not name.startswith(_OBS_HOT_PREFIXES):
            return
        kw = "for" if isinstance(node, ast.For) else "while"
        self._flag(
            "L009", node,
            f"Python `{kw}` loop inside an obs hot path "
            f"(`{self._fn_stack[-1].name}`) — the hub's cost contract is "
            "tuple-append per op and array passes per flush; vectorize "
            "it, or add `# lint: allow-obs-loop (<why this is not "
            "per-element work>)`")


# ---------------------------------------------------------------- frontends
def lint_source(text: str, path: str, *, rel: Optional[str] = None,
                rules: Optional[Set[str]] = None) -> List[LintFinding]:
    """Lint one module's source.  ``rel`` is the path relative to the
    package root (used for scoping rules); defaults to ``path``."""
    rel = rel if rel is not None else path
    rules = set(RULES) if rules is None else set(rules)
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, "E000",
                            f"syntax error: {e.msg}")]
    linter = _Linter(path, rel, text, rules)
    linter.visit(tree)
    # unknown pragma names are findings too — a typo'd pragma silently
    # suppressing nothing (or meant to suppress something) is a trap
    for line, names in sorted(linter.pragmas.items()):
        for n in sorted(names):
            if n.startswith("?"):
                linter.findings.append(LintFinding(
                    path, line, "E001",
                    f"unknown lint pragma `allow-{n[1:]}` (valid: "
                    f"{', '.join(sorted(_ALIASES))} or a rule id)"))
    # L006 pragma hygiene: every pragma must say WHY it is safe, and must
    # actually suppress something — a stale pragma is a license that
    # outlived its exemption and will silently cover a future regression
    if "L006" in rules:
        for line, rule, name, why in _pragma_sites(text):
            if rule.startswith("?"):
                continue                     # already an E001 above
            if not why:
                linter.findings.append(LintFinding(
                    path, line, "L006",
                    f"pragma `allow-{name}` lacks a justification — "
                    f"write `# lint: allow-{name} (<why this site is "
                    "exempt>)`"))
            elif rule in rules and (line, rule) not in linter.used_pragmas:
                linter.findings.append(LintFinding(
                    path, line, "L006",
                    f"stale pragma `allow-{name}`: {rule} no longer "
                    "fires on this line — delete the pragma (it would "
                    "silently cover a future regression)"))
    linter.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return linter.findings


def _package_root() -> str:
    """The installed ``repro_torch`` package directory (default lint
    target)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(here)


def default_paths() -> List[str]:
    """The repro_torch package plus the repo's ``tests/`` and
    ``benchmarks/`` trees when present (a src-layout checkout) — pragma
    hygiene and the nondeterminism rule apply to test/bench code too."""
    pkg = _package_root()
    out = [pkg]
    repo = os.path.dirname(os.path.dirname(pkg))  # src/repro_torch -> repo
    for extra in ("tests", "benchmarks"):
        d = os.path.join(repo, extra)
        if os.path.isdir(d):
            out.append(d)
    return out


def lint_paths(paths: List[str], *,
               rules: Optional[Set[str]] = None) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            files: List[Tuple[str, str]] = [(root, os.path.basename(root))]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        files.append((full, os.path.relpath(full, root)))
        for full, rel in sorted(files):
            with open(full, "r", encoding="utf-8") as fh:
                text = fh.read()
            findings += lint_source(text, full, rel=rel, rules=rules)
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="FUSEE protocol lints (L001-L009); exit 1 on findings.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the repro_torch "
                    "package, tests/ and benchmarks/)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    args = ap.parse_args(argv)
    rules = set(args.rules.split(",")) if args.rules else None
    paths = args.paths or default_paths()
    findings = lint_paths(paths, rules=rules)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"protocol lint: {n} finding(s) in "
          f"{', '.join(os.path.relpath(p) if os.path.isabs(p) else p for p in paths)}"
          if n else "protocol lint: clean")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
