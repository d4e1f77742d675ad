from . import collectives
from .launch import spawn_grid
from .mesh import COL_AXIS, ROW_AXIS, Grid

__all__ = ["collectives", "Grid", "ROW_AXIS", "COL_AXIS", "spawn_grid"]
