from repro_torch.configs.base import (ArchConfig, ShapeCell, SHAPES,
                                      get_config, smoke_config)

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "get_config", "smoke_config"]
