from repro_torch.configs.base import (ASSIGNED, ArchConfig, ShapeCell,
                                      SHAPES, get_config, input_specs,
                                      list_archs, smoke_config)

__all__ = ["ASSIGNED", "ArchConfig", "ShapeCell", "SHAPES", "get_config",
           "input_specs", "list_archs", "smoke_config"]
