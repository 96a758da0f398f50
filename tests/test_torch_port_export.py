"""The predict export (`srfdet3d_torch/tools/export.py`), weights passed in,
on `tiny_test_config` (the bitmap rulebook backend).

One artifact a file: the port model with seeded JAX weights (through
`load_jax_params`, class biases zeroed so decoding has work) is exported
at batch 2, saved with `torch.export.save`, loaded through the op library
(`load_artifact`) and called on seeded points with the model's state.
Its outputs against the live port predict: the same keys, scores and
boxes within rtol 1e-5 and atol 1e-6 (`tests/test_export.py`'s bar),
labels and valid exactly.  Against JAX `SRFDet.predict` on the same
weights and points: the detector test's tolerances (scores 1e-5, boxes
1e-4, labels and valid exact).  The graph holds one `srfdet::gather_conv`
node a gathered conv and one `srfdet::eqmatch_rulebook` a subm stage (the
launches of an eager predict on the card), the NMS `while_loop`, and no
host read; the weights are inputs (the file carries none), so another
state gives that model's predict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_tpu.models.head import decode_boxes as j_decode_boxes
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
from srfdet3d_torch.tools import export
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import (check_artifact_outputs, detecting_port,
                               graph_targets, init_shapes, random_variables,
                               uniform_points)

B = 2
T = torch.from_numpy


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg, tcfg = jconfigs.tiny_test_config(), tconfigs.tiny_test_config()
    pts, mask = uniform_points(tcfg, B, 0)
    shapes = init_shapes(jcfg, (("points", pts.shape, "float32"),
                                ("points_mask", mask.shape, "bool")))
    variables = random_variables(shapes, 12)
    head = variables["params"]["bbox_head"]["head_series"]["single_head"]
    head["class_logits"]["bias"][:] = 0.0
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    path = str(tmp_path_factory.mktemp("export") / "tiny.pt2")
    prog = export.export_predict(tcfg, path, model=port, batch_size=B)
    loaded = export.load_artifact(path)
    batch = {"points": T(pts), "points_mask": T(mask)}
    got = loaded.module()(port.state_dict(), batch)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, port=port,
                prog=prog, loaded=loaded, batch=batch, got=got,
                live=port.predict(batch))


def test_round_trip_matches_live_predict(case):
    check_artifact_outputs(case["got"], case["live"])
    assert case["got"]["valid"].sum() > 0


def test_artifact_matches_jax_predict(case):
    jcfg, batch = case["jcfg"], case["batch"]
    model, t = JSRFDet(jcfg), jcfg.test

    @jax.jit
    def run(v, b):
        logits, boxes = model.apply(v, b, train=False)
        return j_decode_boxes(logits[-1], boxes[-1], use_nms=t.use_nms,
                              nms_thr=t.nms_thr, score_thr=t.score_thr,
                              max_per_img=t.max_per_img,
                              post_center_range=t.post_center_range)

    ref = jax.device_get(run(case["variables"], {
        k: jnp.asarray(v.numpy()) for k, v in batch.items()}))
    got = case["got"]
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=1e-4, atol=1e-4)


def test_graph_holds_the_kernels_and_the_loop(case):
    for prog in (case["prog"], case["loaded"]):
        targets = graph_targets(prog)
        enc = case["port"].pts_middle_encoder
        convs = sum(isinstance(m, GatheredConvBN) for m in enc.modules())
        assert targets.count("srfdet.gather_conv.default") == convs
        assert targets.count("srfdet.eqmatch_rulebook.default") == len(
            case["tcfg"].middle.encoder_channels)
        assert targets.count("while_loop") == 1
        assert "aten._local_scalar_dense.default" not in targets
        assert not any(t.startswith(("srfdet.key_hash",
                                     "srfdet.rulebook_lookup"))
                       for t in targets)


def test_graph_holds_no_profiler_node(case):
    """The port's spans (`utils.profiling.span`) leave nothing in the
    program: no record_function node."""
    for prog in (case["prog"], case["loaded"]):
        assert not any(t.startswith("profiler.")
                       for t in graph_targets(prog))


def test_weights_are_inputs(case):
    """The program carries no weight: called with another model's state
    it gives that model's predict."""
    assert not case["loaded"].state_dict
    other = detecting_port(case["tcfg"], seed=3)
    got = case["loaded"].module()(other.state_dict(),
                                  case["batch"])
    want = other.predict(case["batch"])
    check_artifact_outputs(got, want)
    assert want["valid"].sum() > 0
    assert not torch.equal(got["scores"], case["got"]["scores"])
