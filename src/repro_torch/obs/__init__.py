"""Metrics registry (the obs hub and flight recorder are not ported yet:
ROADMAP A11)."""
from .registry import Counter, Gauge, Registry  # noqa: F401
