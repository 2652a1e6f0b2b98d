"""Configurations: the paper's own system configuration and the model
architectures the serving engine runs (``--arch <id>``)."""
from .base import (ArchConfig, MoEConfig, SSMConfig, all_archs, get,  # noqa
                   reduced, register)
from .fusee_paper import FuseePaperConfig  # noqa: F401
