"""The weight bridge at the full width of the six LiDAR-camera (LC)
configs: the JAX package's variable shapes (jax.eval_shape on a batch with
the config's cameras and image size, no init) through load_jax_params,
every leaf consumed once and every port tensor set, with the parameter
counts of both packages equal to the JAX package's."""

import jax
import jax.numpy as jnp
import pytest

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_torch import configs as tconfigs
from torch_port_common import check_bridge

# parameters of each LC model (jax.eval_shape of the JAX package)
LC_PARAMS = {
    "srfdet_voxel_nusc_LC": 103_725_056,
    "srfdet_voxel_r50_LC": 58_037_248,
    "srfdet_pillar_r50_LC": 55_638_128,
    "srfdet_pillar_v299_LC": 101_325_936,
    "srfdet_voxel_kitti_LC": 154_575_067,
    "srfdet_dvoxel_waymo_LC": 75_428_206,
}


@pytest.mark.parametrize("name", sorted(LC_PARAMS))
def test_weight_bridge_lc_full_width(name):
    """A stray leaf and a missing one in img_backbone raise."""
    jcfg = jconfigs.get_config(name)
    ic, p = jcfg.img, jcfg.points_cap
    batch = {
        "points": jax.ShapeDtypeStruct((1, p, jcfg.points_dim), jnp.float32),
        "points_mask": jax.ShapeDtypeStruct((1, p), jnp.bool_),
        "images": jax.ShapeDtypeStruct((1, ic.num_cams) + ic.img_shape + (3,),
                                       jnp.float32),
        "lidar2img": jax.ShapeDtypeStruct((1, ic.num_cams, 4, 4),
                                          jnp.float32)}
    shapes = jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), batch)
    check_bridge(tconfigs.get_config(name), shapes, LC_PARAMS[name],
                 branch="img_backbone")
