"""The seeds of chip_smoke's tiny LC train steps (card against CPU,
TINY_LC_TRAIN) against the conditioning of a float32 step: the port alone
on the CPU, its grads with the weights as seeded and with every weight
scaled by (1 + 1e-6 noise)."""

import copy

import torch

import chip_smoke
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (losses_of, make_optimizer,
                                          train_step)


def _grad_sensitivity(backbone, opts, model_seed, batch_seed, eps=1e-6,
                      steps=2):
    """The port's worst leaf grad change when every weight is scaled by
    (1 + eps noise): max |dg| per trainable leaf over its largest |g|, or
    over 1e-5 of the tree's largest where that is more, as chip_smoke's
    tiny_train holds the card against the CPU (the attention key biases,
    zero up to rounding, left out): how far a float32 rounding difference
    can move a grad at these seeds; the worst over `steps` train steps."""
    cfg = tconfigs.tiny_lc_test_config(backbone, **opts)
    batch = chip_smoke.train_batch(cfg, 2, seed=batch_seed)
    model = SRFDet(cfg, device="cpu", seed=model_seed)
    chip_smoke.seed_dcn_offsets(model)
    opt = make_optimizer(model, cfg, 100)

    def grads(noise):
        m = copy.deepcopy(model)
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + noise * torch.randn(p.shape, generator=g))
        m.train()
        sum(losses_of(m, batch, torch.Generator().manual_seed(0))
            .values()).backward()
        return {n: p.grad for n, p in m.named_parameters()
                if p.grad is not None and not n.endswith("k_proj.bias")}
    worst = 0.0
    for _ in range(steps):
        a, b = grads(0.0), grads(eps)
        tree_max = max(float(g.abs().max()) for g in a.values())
        worst = max(worst, max(float((a[n] - b[n]).abs().max()) /
                               max(float(a[n].abs().max()), 1e-5 * tree_max)
                               for n in a))
        train_step(model, opt, batch, torch.Generator().manual_seed(0))
    return worst


def test_tiny_lc_seeds_are_well_conditioned():
    """chip_smoke's tiny LC train phase holds the card's grads against the
    CPU's at 2e-3 of each leaf's largest, so its configs and seeds
    (TINY_LC_TRAIN) must keep every trainable leaf's grad within 1e-3
    under a 1e-6 change of the weights, in each step it takes; ResNet-50
    takes one step, because at the same seeds its second step moves a
    leaf's grad by more than 1e-2."""
    for backbone, opts, model_seed, batch_seed, steps in \
            chip_smoke.TINY_LC_TRAIN:
        assert _grad_sensitivity(backbone, opts, model_seed, batch_seed,
                                 steps=steps) < 1e-3, backbone
    backbone, opts, model_seed, batch_seed, _ = chip_smoke.TINY_LC_TRAIN[1]
    assert _grad_sensitivity(backbone, opts, model_seed, batch_seed,
                             steps=2) > 1e-2
