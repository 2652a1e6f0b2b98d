"""Models of the serving path on torch devices: the dense decoder LM
(``model.Model``), its attention and FFN layers, ``registry.build`` and
``convert.params_from_jax``.  Counterpart of the JAX package's
``models/`` for the dense family."""
from .convert import params_from_jax  # noqa: F401
from .model import Model  # noqa: F401
from .registry import build  # noqa: F401
