"""Configurations: the paper's own system configuration and the model
architectures the serving engine runs (``--arch <id>``)."""
from .base import (ALL_SHAPES, ArchConfig, MoEConfig, SSMConfig,  # noqa
                   ShapeSpec, all_archs, cells, get, reduced, register)
from .fusee_paper import FuseePaperConfig  # noqa: F401
