"""Protocol sanitizers over recorded runs.

* ``trace``  — a ring-buffer recorder for one-sided verbs (READ / WRITE /
  CAS / FAA and their fleet-mode batch twins), attached to a ``DMPool`` by
  instance-method wrapping so the un-attached pool pays zero cost; the
  profiler (``obs/spans.py``) folds its rows into per-op span trees;
* ``races``  — a vectorized happens-before pass over a recorded trace that
  flags cross-client conflicts the FUSEE protocol does *not* legalize
  (stale-epoch mutations, acked lost empty-slot CASes, unguarded
  write/write conflicts, primary-before-backup clears, torn reads);
  ``python -m repro_torch.analysis.races --storm-seed N`` runs a seeded
  fault storm under the tracer, then the race pass and the heap auditor;
* ``heapcheck`` — a post-drain DM heap / placement-epoch auditor
  (leaks, double references, BAT ownership, replica divergence, the
  ordered keydir against the RACE index);
* ``explore`` — a DPOR model checker that enumerates the schedules of
  small scopes and holds every maximal one to linearizability, the race
  detector and the heap auditor, with ddmin'd ``.npz`` counterexamples;
  ``python -m repro_torch.analysis.explore --scope crash``;
* ``lint``   — AST protocol lints (L001-L009), runnable as
  ``python -m repro_torch.analysis.lint``.

Counterpart of the JAX package's ``analysis`` package, module for module.
As there, ``explore`` and ``lint`` are imported as submodules
(``from repro_torch.analysis import explore``), so their ``-m`` entry
points run without a second copy of the module.
"""
from .trace import VerbTracer  # noqa: F401
from .races import Finding, detect, report  # noqa: F401
from .heapcheck import HeapReport, audit  # noqa: F401
