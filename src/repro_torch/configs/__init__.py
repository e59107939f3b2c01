"""Architecture configs of the transformer family (see :mod:`.base`)."""
from .base import ArchConfig, get_config

__all__ = ["ArchConfig", "get_config"]
