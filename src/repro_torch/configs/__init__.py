"""The paper's own system configuration."""
from .fusee_paper import FuseePaperConfig  # noqa: F401
