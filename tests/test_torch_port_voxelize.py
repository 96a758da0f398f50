"""PyTorch port vs JAX package: voxelization, the VFE, the batch flatten,
and the port's import isolation.  Inputs are made with numpy from a seed
and fed to both; integer outputs must match exactly (valid rows only: the
JAX voxelizer's invalid rows carry no contract), floats within 1e-6."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models.detector import _flatten_voxelization as jflatten
from srfdet3d_tpu.models.vfe import HardSimpleVFE as JVFE
from srfdet3d_tpu.ops import voxelize as jvox
from srfdet3d_torch.config import VoxelizationSpec
from srfdet3d_torch.models.detector import _flatten_voxelization
from srfdet3d_torch.models.vfe import HardSimpleVFE
from srfdet3d_torch.ops.voxelize import voxelize_points_batched

_PC = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0)


def _points(rng, b, p, n_real, spread=12.0):
    """Points partly outside the range, many sharing voxels."""
    pts = np.zeros((b, p, 5), np.float32)
    pts[:, :n_real, :2] = rng.uniform(-spread, spread, (b, n_real, 2))
    pts[:, :n_real, 2] = rng.uniform(-6, 4, (b, n_real))
    pts[:, :n_real, 3:] = rng.uniform(0, 1, (b, n_real, 2))
    # duplicate a block of points so voxels overflow the per-voxel cap
    pts[:, n_real // 2:n_real // 2 + 40] = pts[:, :1]
    mask = np.zeros((b, p), bool)
    mask[:, :n_real] = True
    return pts, mask


def _specs(vs, cap_pts, v_cap):
    kw = dict(voxel_size=vs, point_cloud_range=_PC, max_num_points=cap_pts,
              max_voxels=v_cap)
    return jvox.VoxelizationSpec(**kw), VoxelizationSpec(**kw)


@pytest.mark.parametrize("b,p,vs,cap_pts,v_cap", [
    (2, 1024, (0.25, 0.25, 0.2), 10, 2048),    # tiny config geometry
    (3, 512, (1.0, 1.0, 0.5), 4, 96),          # voxel capacity overflow
    (1, 700, (0.5, 0.5, 8.0), 3, 512),         # one z cell, odd P
])
def test_voxelize_matches_jax(b, p, vs, cap_pts, v_cap):
    rng = np.random.default_rng(b * 7 + p)
    pts, mask = _points(rng, b, p, p * 3 // 4)
    jspec, tspec = _specs(vs, cap_pts, v_cap)
    jv = jvox.voxelize_points_batched(jnp.asarray(pts), jnp.asarray(mask),
                                      jspec, with_counts=False)
    tv = voxelize_points_batched(torch.from_numpy(pts),
                                 torch.from_numpy(mask), tspec)
    vm = np.asarray(jv.voxel_mask)
    np.testing.assert_array_equal(tv.voxel_mask.numpy(), vm)
    np.testing.assert_array_equal(tv.voxel_coords.numpy()[vm],
                                  np.asarray(jv.voxel_coords)[vm])
    np.testing.assert_array_equal(tv.voxel_coords.numpy()[~vm], 0)
    np.testing.assert_array_equal(tv.point_voxel_idx.numpy(),
                                  np.asarray(jv.point_voxel_idx))
    np.testing.assert_array_equal(tv.point_mask.numpy(),
                                  np.asarray(jv.point_mask))
    if v_cap == 96:
        assert vm.all(), "the overflow case must fill every voxel slot"


def test_voxel_cap_keeps_the_smallest_keys_not_the_first_points():
    """Over voxels_cap the JAX package keeps the voxels of the smallest
    plan-major keys ((y * nx + x) * nz + z), and the port with it; the
    reference's mmcv hard voxelization keeps the first voxels in point
    order (keyframe points come before the sweeps').  So a keyframe
    point at high y loses its voxel to later points at low y: in a scene
    that overflows the cap, the objects of the upper half in y vanish
    (ROADMAP Queue 3, item 11; PERF.md, flagship_learn)."""
    n_first, n_later, v_cap = 8, 40, 32
    pts = np.zeros((1, n_first + n_later, 5), np.float32)
    pts[0, :n_first, 0] = np.linspace(-8, 8, n_first)
    pts[0, :n_first, 1] = 8.0                      # the first points: high y
    pts[0, n_first:, 0] = np.linspace(-9.5, 9.5, n_later)
    pts[0, n_first:, 1] = -8.0                     # later points: low y
    mask = np.ones(pts.shape[:2], bool)
    # 0.25 m cells: every point its own voxel, 48 voxels for 32 slots
    jspec, tspec = _specs((0.25, 0.25, 0.5), 4, v_cap)
    jv = jvox.voxelize_points_batched(jnp.asarray(pts), jnp.asarray(mask),
                                      jspec, with_counts=False)
    tv = voxelize_points_batched(torch.from_numpy(pts),
                                 torch.from_numpy(mask), tspec)
    idx = tv.point_voxel_idx.numpy()[0]
    np.testing.assert_array_equal(idx, np.asarray(jv.point_voxel_idx)[0])
    assert (idx[:n_first] == v_cap).all()          # dropped, though first
    assert (idx[n_first:n_first + v_cap] < v_cap).all()
    # first-come (the reference's rule) would have kept all eight


def test_vfe_and_flatten_match_jax():
    """HardSimpleVFE over the flattened batch: float means within 1e-6."""
    rng = np.random.default_rng(5)
    b, p, v_cap = 2, 1024, 512
    pts, mask = _points(rng, b, p, 900)
    jspec, tspec = _specs((0.5, 0.5, 0.4), 5, v_cap)
    jv = jvox.voxelize_points_batched(jnp.asarray(pts), jnp.asarray(mask),
                                      jspec, with_counts=False)
    jflat = jflatten(jv, v_cap)
    jfeat = JVFE(num_features=5).apply(
        {}, jnp.asarray(pts.reshape(b * p, 5)), jflat, b * v_cap)
    tv = voxelize_points_batched(torch.from_numpy(pts),
                                 torch.from_numpy(mask), tspec)
    tflat = _flatten_voxelization(tv, v_cap)
    np.testing.assert_array_equal(tflat.point_voxel_idx.numpy(),
                                  np.asarray(jflat.point_voxel_idx))
    tfeat = HardSimpleVFE(5)(torch.from_numpy(pts.reshape(b * p, 5)), tflat,
                             b * v_cap)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=1e-6,
                               atol=1e-6)


def test_port_imports_no_jax():
    """Importing the whole port, the train step's modules, the checkpoint
    converter, the data-parallel package and the host side (the C++
    point route, create_data, profiling, event files, vis/) included, and
    chip_smoke.py (its reference-naming exporter), pulls in neither jax
    nor srfdet3d_tpu, nor cv2 or tensorflow (both absent from the card
    machine), nor scipy (imported by the hungarian assigner's host solve
    alone, when it runs)."""
    code = (
        "import sys, pkgutil, importlib, srfdet3d_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(srfdet3d_torch.__path__, "
        "'srfdet3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'srfdet3d_tpu', 'cv2', 'tensorflow', "
        "'tensorboard', 'scipy')]\n"
        "assert not bad, bad\n"
        "need = ['assign.ota', 'models.losses', 'ops.focal_loss', "
        "'ops.gather_conv_bwd', 'ops.roi_scatter', 'train.trainer', "
        "'models.middle', 'configs', 'models.vovnet', 'models.resnet', "
        "'models.deform_conv', 'data.box_np', 'data.transforms', "
        "'data.img_transforms', 'data.datasets', 'data.loader', "
        "'data.synthetic_root', 'evals.nuscenes_eval', 'evals.kitti_eval', "
        "'evals.waymo_eval', 'evals.formatters', 'utils.checkpoint', "
        "'utils.logging', 'tools.train', 'tools.test', "
        "'utils.torch_convert', 'tools.convert_checkpoint', "
        "'tools.eval_results_from_pkl', 'parallel', 'parallel.mesh', "
        "'data.native', 'tools.create_data', 'utils.profiling', "
        "'utils.event_file', 'vis', 'vis.show_result', "
        "'tools.show_results_from_pkl', 'tools.mix_imgs_convert_video', "
        "'assign.hungarian', 'models.deform_attn']\n"
        "missed = [n for n in need if 'srfdet3d_torch.' + n not in "
        "sys.modules]\n"
        "assert not missed, missed\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda():
    """Without an explicit device the model asks for CUDA and raises when
    there is none; it never falls back to the CPU on its own."""
    from srfdet3d_torch import resolve_device
    from srfdet3d_torch.config import ImgBranchConfig
    from srfdet3d_torch.configs import tiny_test_config
    from srfdet3d_torch.models.detector import SRFDet
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SRFDet(tiny_test_config())
    # the train and test CLIs without --device ask for the card too
    from srfdet3d_torch.tools import test as test_cli
    from srfdet3d_torch.tools import train as train_cli
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["tiny", "--synthetic"])
    # the image branch in bfloat16 is not ported (float32 is)
    bf16 = dataclasses.replace(ImgBranchConfig(), compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        SRFDet(dataclasses.replace(tiny_test_config(), use_img=True,
                                   img=bf16), device="cpu")


def test_backend_flags_keep_a_deterministic_choice():
    """SRFDet sets cudnn.benchmark, unless the caller asked for
    deterministic cuDNN (chip_smoke's flagship_learn): then cuDNN's
    heuristic choice stays, with benchmark off."""
    from srfdet3d_torch import set_backend_flags
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic = False
        set_backend_flags()
        assert torch.backends.cudnn.benchmark
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.deterministic = True
        set_backend_flags()
        assert not torch.backends.cudnn.benchmark
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
