"""Cluster observability: typed metrics registry, op-level flight
recorder, per-MN load time-series, heat sketches, trace export, causal op
span trees with critical-path RTT attribution, and the hot-key monitor.

FUSEE's client-centric design leaves no metadata server where telemetry
naturally accumulates; this package is the deterministic, vectorized
substitute.  Counterpart of the JAX package's ``obs`` package: host numpy
that samples host state only, so a snapshot is byte-identical across
packages and devices for the same seeded run.
"""
from .registry import (Counter, Gauge, HeatSketch, Histogram,  # noqa: F401
                       LegacyCounters, PATH_DEPENDENT, Registry, Series,
                       deterministic_view, legacy_counters_view,
                       snapshot_diff, snapshot_merge)
from .flight import (ClusterObs, FlightRecorder,  # noqa: F401
                     EV_BEGIN, EV_FAULT, EV_MIG, EV_RECOVERY, EV_REGIME,
                     EV_SETTLE, EV_NAMES, FIELDS)
from .export import (flight_to_perfetto, load_flight,  # noqa: F401
                     load_metrics, load_perfetto, metrics_to_json)
from .spans import (SpanSet, build_spans,  # noqa: F401
                    spans_from_cluster, spans_to_perfetto,
                    FLAG_PARTIAL, FLAG_OVER, FLAG_OPEN, FLAG_CRASHED,
                    UNTRACED)
from .profile import (critical_path_report, format_report,  # noqa: F401
                      tick_phase_report)
from .hotspot import HotKeyMonitor, SpaceSaving, zipf_theta  # noqa: F401
