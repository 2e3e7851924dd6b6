"""Architecture configs (``repro/configs``)."""
from repro_torch.configs.base import (LONG_CONTEXT_FAMILIES, SHAPES, ArchConfig,  # noqa: F401
                                      ShapeSpec)
