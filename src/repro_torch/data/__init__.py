"""Deterministic synthetic data pipeline (counterpart of the JAX
package's ``data/``)."""
from .pipeline import DataConfig, SyntheticLM  # noqa: F401
