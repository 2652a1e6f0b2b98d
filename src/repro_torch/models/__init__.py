"""Models on torch devices: the LM of every configuration (``model.Model``:
the training forward and loss, prefill and decode), its attention, FFN /
MoE, mamba and xLSTM layers, ``registry.build`` / ``param_stats`` and
``convert.params_from_jax``.  Counterpart of the JAX package's
``models/``."""
from .convert import params_from_jax  # noqa: F401
from .model import Model  # noqa: F401
from .registry import build, param_stats  # noqa: F401
