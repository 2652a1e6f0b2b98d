"""Hand-written Hopper kernels of the port, each beside its plain torch
version (the CPU path and the oracle) and with a launch counter:

* race_lookup — batched RACE hash-index probe (FUSEE SEARCH phase 1)
* fleet_tick  — ragged fused-tick READ sweep over the flat region slab
* leaf_probe  — batched ordered-keydir leaf locate (SCAN/RANGE starts)
* flash_attention — forward GQA attention for prefill (online softmax)
* paged_attention — one-token decode attention over the FUSEE block pool

CUDA sources live in ``repro_torch/csrc``; ``build.py`` compiles them with
nvcc on first use and binds them with ctypes.
"""
from .fleet_tick import fleet_read, fleet_read_plain  # noqa: F401
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_plain)
from .leaf_probe import leaf_probe, leaf_probe_plain  # noqa: F401
from .paged_attention import (paged_attention,  # noqa: F401
                              paged_attention_plain)
from .race_lookup import race_lookup, race_lookup_plain  # noqa: F401

KERNELS = (race_lookup, fleet_read, leaf_probe, flash_attention,
           paged_attention)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
