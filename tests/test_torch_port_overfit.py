"""The learning check of the port (test_overfit.py's, on the port's head and
losses): the head at test_overfit.py's tiny sizes (batch 2, 24 proposals, C
32, two iterations, four BEV levels) overfits two planted GT boxes in 60
AdamW steps at optax's defaults and lr 2e-3, from the same seeded JAX init
(through the weight bridge), and decode finds them again.  The first step's
total loss equals the JAX package's (its jitted loss on the same weights
and features) within rtol 1e-5 (float32 op order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srfdet3d_tpu.assign import OTAConfig as JOTAConfig
from srfdet3d_tpu.models.head import SRFDetHead as JHead
from srfdet3d_tpu.models.losses import LossConfig as JLossConfig
from srfdet3d_tpu.models.losses import srfdet_losses as j_losses
from srfdet3d_torch.config import LossConfig, OTAConfig
from srfdet3d_torch.models.head import SRFDetHead, decode_boxes
from srfdet3d_torch.models.losses import srfdet_losses
from srfdet3d_torch.utils.jax_params import jax_state_dict

PC = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0)
VS = (0.125, 0.125, 0.2)
B, NP, NCLS, C = 2, 24, 3, 32
SIZES = [(20, 20), (10, 10), (5, 5), (3, 3)]
HEAD = dict(num_proposals=NP, num_heads=2, num_dpg_exp=2, dim_feedforward=64,
            num_attn_heads=4, dynamic_dim=8, dropout=0.0)


def planted():
    """test_overfit.py's features and GTs: two boxes a sample (a car-sized
    one of class 0, a pedestrian-sized one of class 2), two padding rows."""
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(B, h, w, C)).astype(np.float32)
             for h, w in SIZES]
    gt = np.zeros((B, 4, 9), np.float32)
    gt[:, 0, :7] = [3.0, 2.0, -1.0, 1.8, 4.2, 1.6, 0.3]
    gt[:, 1, :7] = [-4.0, -3.0, -0.5, 0.6, 0.8, 1.7, -1.2]
    labels = np.zeros((B, 4), np.int32)
    labels[:, 1] = 2
    mask = np.zeros((B, 4), bool)
    mask[:, :2] = True
    return feats, gt, labels, mask


def test_head_overfits_and_decodes_planted_boxes():
    feats, gt, labels, mask = planted()
    jhead = JHead(num_classes=NCLS, feat_channels_lidar=C, hidden_dim=C,
                  pc_range=PC, voxel_size=VS, **HEAD)
    jfeats = [jnp.asarray(f) for f in feats]
    # jitted: the eager init dispatches hundreds of small programs
    variables = jax.jit(lambda k: jhead.init(k, jfeats, train=False))(
        jax.random.PRNGKey(0))
    lcfg, ocfg = JLossConfig(num_classes=NCLS), JOTAConfig(pc_range=PC)

    @jax.jit
    def j_total(variables):
        (lg, bx), _ = jhead.apply(variables, jfeats, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(1)},
                                  mutable=["batch_stats"])
        return sum(j_losses(lg, bx, jnp.asarray(gt), jnp.asarray(labels),
                            jnp.asarray(mask), lcfg, ocfg).values())

    j_first = float(j_total(variables))

    head = SRFDetHead(NCLS, C, len(SIZES), SIZES[-1][0] * SIZES[-1][1],
                      pc_range=PC, voxel_size=VS,
                      lidar_strides=(8, 16, 32, 64), roi_patch=0,
                      roi_patch_fallback=-1, **HEAD)
    host = jax.tree_util.tree_map(np.asarray, variables)
    state = jax_state_dict({c: {"bbox_head": host[c]} for c in host},
                           n_heads=2, n_cls_convs=2)
    own = {k for k in head.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert {k[len("bbox_head."):] for k in state} == own
    head.load_state_dict({k[len("bbox_head."):]: torch.from_numpy(v.copy())
                          for k, v in state.items()}, strict=False)
    opt = torch.optim.AdamW(head.parameters(), lr=2e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()
              for f in feats]
    tgt, tlab, tmask = (torch.from_numpy(a) for a in (gt, labels, mask))
    lc, oc = LossConfig(num_classes=NCLS), OTAConfig(pc_range=PC)
    totals = []
    head.train()
    for _ in range(60):
        opt.zero_grad()
        lg, bx = head(tfeats)
        total = sum(srfdet_losses(lg, bx, tgt, tlab, tmask, lc, oc).values())
        total.backward()
        opt.step()
        totals.append(float(total.detach()))
    np.testing.assert_allclose(totals[0], j_first, rtol=1e-5)
    assert totals[-1] < 0.5 * totals[0], f"loss {totals[0]} -> {totals[-1]}"

    head.eval()
    with torch.no_grad():
        lg, bx = head(tfeats)
    out = decode_boxes(lg[-1], bx[-1], max_per_img=6, score_thr=0.05)
    v = out["valid"][0].numpy()
    assert v.any(), "no detections after the overfit"
    top = out["boxes"][0].numpy()[v][0]
    err = min(np.linalg.norm(top[:2] - gt[0, g, :2]) for g in range(2))
    assert err < 1.0, f"top box {top[:2]} vs GTs {gt[0, :2, :2]}"
