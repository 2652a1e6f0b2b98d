"""Protocol analysis over recorded runs.

``trace`` — a ring-buffer recorder for one-sided verbs (READ / WRITE / CAS
/ FAA and their fleet-mode batch twins), attached to a ``DMPool`` by
instance-method wrapping so the un-attached pool pays zero cost.  The
profiler (``obs/spans.py``) folds its rows into per-op span trees.

Counterpart of the JAX package's ``analysis`` package; its race detector,
heap auditor, DPOR explorer and lints are not ported yet (ROADMAP A12.2).
"""
from .trace import VerbTracer  # noqa: F401
