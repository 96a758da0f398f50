"""Result visualization (the JAX package's `vis/`): BEV rasters, camera
projections, obj and ply scene files."""

from .show_result import (show_bev_result, show_multi_modality_result,
                          show_result, write_obj, write_ply)

__all__ = ["show_bev_result", "show_multi_modality_result", "show_result",
           "write_obj", "write_ply"]
