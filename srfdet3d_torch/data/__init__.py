"""The host-side data pipeline: info-pickle datasets, the point and image
transforms, CBGS, collate and the prefetching loader (numpy; the JAX
package's `data/`, copied)."""

from .transforms import (load_points_bin, multi_sweep_aggregate,
                         global_rot_scale_trans, random_flip_3d,
                         points_range_filter, object_range_filter,
                         object_name_filter, point_shuffle, pad_points,
                         pad_gts, filter_pad, DBSampler, limit_period)
from .datasets import (SRFDetDataset, NuScenesDataset, KittiDataset,
                       WaymoDataset, SyntheticDataset, CBGSWrapper,
                       collate_batch)
from .loader import data_loader

__all__ = [
    "load_points_bin", "multi_sweep_aggregate", "global_rot_scale_trans",
    "random_flip_3d", "points_range_filter", "object_range_filter",
    "object_name_filter", "point_shuffle", "pad_points", "pad_gts",
    "filter_pad", "DBSampler", "limit_period",
    "SRFDetDataset", "NuScenesDataset", "KittiDataset", "WaymoDataset",
    "SyntheticDataset", "CBGSWrapper", "collate_batch", "data_loader",
]
