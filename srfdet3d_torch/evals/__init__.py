from .nuscenes_eval import nuscenes_eval, NUS_CLASS_RANGES
from .kitti_eval import kitti_eval
from .waymo_eval import waymo_eval

__all__ = ["nuscenes_eval", "NUS_CLASS_RANGES", "kitti_eval", "waymo_eval"]
