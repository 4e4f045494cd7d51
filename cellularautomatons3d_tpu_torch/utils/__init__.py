from .config import EngineConfig, LightConfig, BoundaryMode, snap_grid_size
from . import mat4

__all__ = ["EngineConfig", "LightConfig", "BoundaryMode", "snap_grid_size", "mat4"]
