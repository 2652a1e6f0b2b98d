"""Optimizers, schedules, gradient clipping and gradient compression.

Counterpart of the JAX package's ``optim/``."""
from .compress import init_error_feedback, pod_compressed_mean  # noqa: F401
from .optimizer import (Moment, OptConfig, Optimizer, clip_by_global_norm,  # noqa
                        global_norm, opt_state_from_jax, schedule,
                        tree_leaves, tree_map)
