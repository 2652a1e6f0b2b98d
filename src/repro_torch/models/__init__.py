"""Models on torch devices: the dense decoder LM (``model.Model``: the
training forward and loss, prefill and decode), its attention and FFN
layers, ``registry.build`` and ``convert.params_from_jax``.  Counterpart of the JAX package's
``models/`` for the dense stack."""
from .convert import params_from_jax  # noqa: F401
from .model import Model  # noqa: F401
from .registry import build  # noqa: F401
