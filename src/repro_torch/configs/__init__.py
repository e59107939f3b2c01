"""Architecture configs (see :mod:`.base`)."""
from .base import (ARCH_IDS, LONG_CONTEXT_OK, SHAPES, ArchConfig,
                   ShapeConfig, cells, get_config)

__all__ = ["ARCH_IDS", "LONG_CONTEXT_OK", "SHAPES", "ArchConfig",
           "ShapeConfig", "cells", "get_config"]
