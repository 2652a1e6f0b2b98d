from .ops import fleet_read, fleet_read_plain  # noqa: F401
