from .ops import race_lookup, race_lookup_plain  # noqa: F401
