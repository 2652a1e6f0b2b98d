from .ops import leaf_probe, leaf_probe_plain  # noqa: F401
