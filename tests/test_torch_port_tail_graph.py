"""Predict's tail as one CUDA graph (`models/tail_graph.py`), on the CPU:

- the head's forward copies no constant from host memory once its
  constants exist (`utils/constants.py`), at the flagship's published
  widths and on the tiny LC head (image RoIAlign, DPG resize), with the
  same bits as constants made afresh on every call;
- when `SRFDet.tail_graphed` engages, case by case;
- the sparse encoder's `sparse` + `dense` against its forward;
- the detector's graphed forward with a stand-in for the capture (a
  replay that runs the captured function again into the static outputs):
  the outputs, the hooks, the counters, new inputs, a replaced parameter,
  `train()` and `to()`.

The graph itself runs on the card only (`chip_smoke.py`'s `tail_graph`
phase)."""

import dataclasses

import pytest
import torch

from srfdet3d_torch.configs import get_config, tiny_lc_test_config
from srfdet3d_torch.models import detector as tdetector
from srfdet3d_torch.models import tail_graph
from srfdet3d_torch.models.detector import SRFDet, bev_geometry
from srfdet3d_torch.tools.export import synthetic_batch
from srfdet3d_torch.utils import constants, profiling

torch.set_num_threads(1)


def _syncs(fn):
    """(fn's result, the host_sync counter's move over it)."""
    before = profiling.snapshot().get("host_sync", 0)
    out = fn()
    return out, profiling.snapshot().get("host_sync", 0) - before


class _NoCache(dict):
    """A constants cache that keeps nothing: every call copies afresh, as
    `new_tensor` did."""

    def __setitem__(self, key, value):
        pass


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _maps(cfg, seed=0, b=1):
    g = torch.Generator().manual_seed(seed)
    _, sizes = bev_geometry(cfg)
    return [torch.randn(b, cfg.neck_out_channels, h, w, generator=g)
            for h, w in sizes]


@torch.no_grad()
def test_flagship_head_forward_adds_no_host_sync(monkeypatch):
    """At the flagship's widths (900 proposals, 5 refinements, the patch
    RoIAlign): the first forward makes each distinct constant once, the
    next one copies nothing from host memory, with the same outputs."""
    monkeypatch.setattr(constants, "_cache", {})
    cfg = get_config("srfdet_voxel_nusc_L")
    head = SRFDet(cfg, device="cpu").bbox_head
    maps = _maps(cfg)
    first, made = _syncs(lambda: head(maps))
    again, syncs = _syncs(lambda: head(maps))
    assert syncs == 0
    assert made == len(constants._cache) > 0
    assert _equal(first, again)


def _lc_inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    ic = cfg.img
    n = ic.num_cams
    h, w = ic.img_shape
    imgs = [torch.randn(n, ic.neck_out_channels, h // s, w // s,
                        generator=g) for s in cfg.head.img_strides]
    l2i = torch.eye(4).repeat(1, n, 1, 1) + 0.1 * torch.randn(
        1, n, 4, 4, generator=g)
    return imgs, l2i


@pytest.mark.parametrize("case", ["tiny", "tiny_bf16", "tiny_lc"])
@torch.no_grad()
def test_head_constants_keep_the_bits(monkeypatch, case):
    """Cached constants against constants copied afresh on every call:
    the same outputs bit for bit (float32 and the bfloat16 model), and no
    host sync once cached; afresh, the tiny head copies 14 a refinement
    (denormalize_centers, lidar_rois_from_boxes, apply_deltas, two level
    geometries) and 2 for the last denormalize_centers, and the LC head 4
    more a refinement (the image RoIAlign's level geometry) and 2 for
    the DPG resize's index vectors."""
    cfg = get_config("tiny") if case != "tiny_lc" else \
        tiny_lc_test_config("vovnet")
    # the patch rule, as the flagship's: its fit test reads the level
    # geometry a second time
    cfg = cfg.replace(head=dataclasses.replace(
        cfg.head, roi_patch=4, roi_patch_fallback=2))
    if case == "tiny_bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    head = SRFDet(cfg, device="cpu", seed=3).bbox_head
    args = [_maps(cfg, seed=1)]
    if case == "tiny_lc":
        args += [None, *_lc_inputs(cfg)]
    monkeypatch.setattr(constants, "_cache", _NoCache())
    fresh, copies = _syncs(lambda: head(*args))
    iters = cfg.head.num_heads
    want = 14 * iters + 2 + (4 * iters + 2 if case == "tiny_lc" else 0)
    assert copies == want
    monkeypatch.setattr(constants, "_cache", {})
    head(*args)
    cached, syncs = _syncs(lambda: head(*args))
    assert syncs == 0
    assert _equal(fresh, cached)
    assert fresh[0].dtype == (torch.bfloat16 if case == "tiny_bf16"
                              else torch.float32)


def test_constant_follows_new_tensor(monkeypatch):
    monkeypatch.setattr(constants, "_cache", {})
    like = torch.zeros(2, dtype=torch.bfloat16)
    got = constants.constant((0.1, 55.2), like)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, like.new_tensor((0.1, 55.2)))
    assert constants.constant((0.1, 55.2), like) is got
    # ints and floats that hash alike keep their own dtypes
    ints = constants.constant((1, 2))
    floats = constants.constant((1.0, 2.0))
    assert (ints.dtype, floats.dtype) == (torch.int64, torch.float32)
    # made inside inference mode, a train step may still save it
    with torch.inference_mode():
        made = constants.constant((3.0,))
    assert not made.is_inference()
    # nothing is cached for a fake or meta tensor
    meta = constants.constant((1.0,), torch.zeros(1, device="meta"))
    assert meta.device.type == "meta" and len(constants._cache) == 4


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    return cfg, SRFDet(cfg, device="cpu", seed=1)


@pytest.fixture(scope="module")
def tiny_lc():
    cfg = tiny_lc_test_config("vovnet")
    return cfg, SRFDet(cfg, device="cpu", seed=1)


def _on_card(monkeypatch):
    """The model reports a card (the predicate's device check)."""
    monkeypatch.setattr(SRFDet, "device",
                        property(lambda self: torch.device("cuda")))


ENGAGE_CASES = ["engages", "grad_enabled", "train_mode", "images",
                "lc_without_images", "proposal_block", "exporting",
                "compiling", "cpu", "pillar"]


@pytest.mark.parametrize("case", ENGAGE_CASES)
def test_tail_graph_engages_only_where_it_may(monkeypatch, tiny, tiny_lc,
                                              case):
    cfg, net = tiny
    batch = {"points": None}
    if case in ("images", "lc_without_images"):
        cfg, net = tiny_lc
        if case == "images":
            batch["images"] = None
    if case == "pillar":
        cfg = get_config("tiny_pillar")
        net = SRFDet(cfg, device="cpu")
    if case != "cpu":
        _on_card(monkeypatch)
    if case == "proposal_block":
        monkeypatch.setattr(tdetector.pmesh, "shards", lambda n: True)
    if case in ("exporting", "compiling"):
        monkeypatch.setattr(torch.compiler, "is_" + case, lambda: True)
    want = case in ("engages", "lc_without_images")
    net.train(case == "train_mode")
    try:
        with torch.set_grad_enabled(case == "grad_enabled"):
            assert net.tail_graphed(batch) is want
    finally:
        net.eval()


@pytest.mark.parametrize("name", ["tiny", "tiny_table", "tiny_kitti"])
@torch.no_grad()
def test_encoder_sparse_then_dense_is_forward(name):
    cfg = get_config("tiny_kitti" if name == "tiny_kitti" else "tiny")
    if name == "tiny_table":
        cfg = cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                     rulebook="table"))
    net = SRFDet(cfg, device="cpu", seed=2)
    batch = synthetic_batch(cfg, 2, seed=4)
    feats, vox = net.voxel_features(*net._inputs(batch))
    enc = net.pts_middle_encoder
    args = (feats, vox.voxel_coords, vox.voxel_mask)
    whole = enc(*args)
    feats_o, coords, mask = enc(*args, dense=False)
    cap = cfg.middle.capacities[-1]
    assert feats_o.shape == (2, cap, cfg.middle.output_channels)
    assert coords.shape == (2, cap, 3) and mask.shape == (2, cap)
    assert torch.equal(enc.dense(feats_o, coords, mask), whole)
    assert _equal(enc.sparse(*args), (feats_o, coords, mask))
    d, h, w = enc.out_shape
    assert whole.shape == (2, h, w, d * cfg.middle.output_channels)
    assert d == bev_geometry(cfg)[0]


class _Replay:
    """Stands in for a CUDA graph: a replay runs the captured function
    again on the static inputs and writes the static outputs."""

    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn(*self.static)):
            out.copy_(new)


def _fake_capture(fn, inputs, bound):
    static = tuple(t.clone() for t in inputs)
    outputs = tuple(t.clone() for t in fn(*static))
    return tail_graph.Captured(_Replay(fn, static, outputs), static, outputs,
                               bound)


@torch.no_grad()
def test_graphed_forward_with_a_stand_in_capture(monkeypatch):
    """Four frames replayed equal the eager forward bit for bit, and a
    fifth frame after new inputs gives its own outputs; the head's hooks
    get each frame's outputs, which later frames leave alone; one capture,
    a replay a frame, no eager count; a replaced parameter or a module
    attribute set anew captures anew, train() and to() drop the graph."""
    monkeypatch.setattr(tail_graph, "capture", _fake_capture)
    monkeypatch.setattr(SRFDet, "tail_graphed", lambda self, batch: (
        not self.training and not torch.is_grad_enabled()))
    cfg = get_config("tiny")
    net = SRFDet(cfg, device="cpu", seed=5)
    last = {}
    net.bbox_head.register_forward_hook(
        lambda m, a, out: last.update(out=out))
    frames = [synthetic_batch(cfg, 1, seed=s) for s in range(5)]
    profiling.reset("tail_graph.")

    def eager(batch):
        with torch.enable_grad():
            return tuple(t.detach() for t in net(batch))
    got, kept = [], []
    for b in frames:
        got.append(net(b))
        # what the head's hooks last saw in the frame, kept by reference
        kept.append(last["out"])
    want = [eager(b) for b in frames]
    for g, w, k in zip(got, want, kept):
        assert _equal(g, w) and _equal(k, w)
    assert not _equal(got[4], got[3])
    assert profiling.snapshot().get("tail_graph.captures") == 1
    assert profiling.snapshot().get("tail_graph.replays") == 5
    assert "tail_graph.eager" not in profiling.snapshot()
    # predict decodes the replayed outputs
    dec = net.predict(frames[0])
    assert _equal(dec.values(), net.decode(want[0]).values())
    # a parameter put in another's place: captured anew, its values used
    lin = net.bbox_head.heads[-1].class_logits
    lin.weight = torch.nn.Parameter(lin.weight * 2.0)
    wide = net(frames[1])
    assert _equal(wide, eager(frames[1]))
    assert profiling.snapshot()["tail_graph.captures"] == 2
    # an attribute set anew (a narrower RoI patch, misfits dropped): the
    # same, and again once it is set back
    heads = net.bbox_head.heads
    own = [(h.roi_patch, h.roi_patch_fallback) for h in heads]
    for h in heads:
        h.roi_patch, h.roi_patch_fallback = 2, 0
    narrow = net(frames[1])
    assert _equal(narrow, eager(frames[1]))
    assert not _equal(narrow, wide)
    for h, (patch, fallback) in zip(heads, own):
        h.roi_patch, h.roi_patch_fallback = patch, fallback
    assert _equal(net(frames[1]), eager(frames[1]))
    assert profiling.snapshot()["tail_graph.captures"] == 4
    # train() and to() drop the graphs
    net.train()
    assert len(net._tail_graphs) == 0
    net.eval()
    net(frames[0])
    assert len(net._tail_graphs) == 1
    net.to("cpu")
    assert len(net._tail_graphs) == 0


def test_muted_spans_record_nothing(tmp_path):
    """A graph's warm-up and capture run under profiling.muted: no span
    of theirs reaches the record."""
    with profiling.trace(str(tmp_path), "cpu"):
        with profiling.muted():
            with profiling.span("bev"):
                pass
        with profiling.span("tail_graph"):
            pass
    assert [r.name for r in profiling.recorded()] == ["tail_graph"]
