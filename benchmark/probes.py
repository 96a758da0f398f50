"""The sparse convs' weight gradients held by themselves: K3 (submanifold)
and K4 (strided) return dW, which the whole step's gradient cannot hold
(at random weights the LiDAR branch's gradient is not set by float32
arithmetic: PERF.md).  So the checked run's first step projects each
call's inputs and its dW on random vectors, and the reference, following
that step, works the same projection out again from its own rulebook.

For the forward out[m] = sum_k feats[idx[m, k]] W_k (idx's miss row is
N, a zero row), dL/dW_k = sum_m feats[idx[m, k]]^T g[m], so with u over
Cin and v over Cout

    u^T dW_k v = sum_m a[idx[m, k]] b[m],   a = feats u,  b = g v.

The run keeps a, b and its projected dW (u^T dW_k v, k = 1..K) a call;
the reference gathers a by the rulebook it builds itself and sums in
float64.  conv_gap = ||got - ref|| / ||ref|| over k: random u, v keep the
norm of the projections that of dW, so the gap reads dW's relative
error (a halved dW reads 0.5).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

# the system's module whose functions the sparse convs' backward calls
SYSTEM_OPS = "srfdet3d_torch.ops.sparse_conv"
KINDS = (("subm_conv_bwd", "k3"), ("strided_conv_bwd", "k4"))


class ConvGradProbe:
    """While open, each weight gradient the system's K3 and K4 return is
    projected (`calls`, on the host): module name, kernel, a, b (float32)
    and the projected dW (float64)."""

    def __init__(self, net, seed: int):
        self.ops = importlib.import_module(SYSTEM_OPS)
        self.names = {p.data_ptr(): n[: -len(".kernel")]
                      for n, p in net.named_parameters()
                      if n.endswith(".kernel")}
        self.gen = torch.Generator().manual_seed(seed)
        self.calls: List[Dict] = []
        self.orig = {}
        for attr, kind in KINDS:
            fn = getattr(self.ops, attr)
            self.orig[attr] = fn
            setattr(self.ops, attr, self._wrap(fn, kind))

    def _wrap(self, fn, kind):
        def call(feats, idx, weights, g, need_dfeats=True):
            dfeats, dw = fn(feats, idx, weights, g, need_dfeats)
            name = self.names.get(weights.data_ptr())
            if name is not None:
                with torch.no_grad():
                    u = torch.randn(dw.shape[1], generator=self.gen,
                                    dtype=torch.float64).to(dw.device)
                    v = torch.randn(dw.shape[2], generator=self.gen,
                                    dtype=torch.float64).to(dw.device)
                    self.calls.append(dict(
                        name=name, kernel=kind,
                        a=(feats.double() @ u).float().cpu(),
                        b=(g.double() @ v).float().cpu(),
                        proj=torch.einsum("kio,i,o->k", dw.double(), u,
                                          v).cpu()))
            return dfeats, dw
        return call

    def close(self) -> None:
        for attr, fn in self.orig.items():
            setattr(self.ops, attr, fn)


class RulebookTap:
    """While open, the rulebook each of the reference's gathered convs
    runs with, by module name, and the row count it gathers from."""

    def __init__(self, net, conv_type):
        self.books: Dict[str, tuple] = {}
        self._handles = [
            mod.register_forward_pre_hook(self._hook(name))
            for name, mod in net.named_modules()
            if isinstance(mod, conv_type)]

    def _hook(self, name):
        def hook(mod, args):
            feats, gidx = args[0], args[1]
            b, v = feats.shape[0], feats.shape[1]
            self.books[name] = (gidx.reshape(-1, gidx.shape[-1]), b * v)
        return hook

    def close(self) -> None:
        for h in self._handles:
            h.remove()


def conv_gaps(calls: List[Dict], books: Dict[str, tuple]) -> List[tuple]:
    """(kernel, name, gap) of each probed call against the reference's
    rulebook of the same conv; inf where the reference ran no such conv
    or its rulebook has another shape."""
    out = []
    for c in calls:
        book = books.get(c["name"])
        if book is None or book[0].shape[0] != c["b"].shape[0] \
                or book[1] != c["a"].shape[0]:
            out.append((c["kernel"], c["name"], float("inf")))
            continue
        idx, n = book
        dev = idx.device
        a = torch.cat([c["a"].to(dev, torch.float64),
                       torch.zeros(1, dtype=torch.float64, device=dev)])
        b = c["b"].to(dev, torch.float64)
        ref = (a[idx.long()] * b[:, None]).sum(0).cpu()
        gap = float((c["proj"] - ref).norm() / ref.norm().clamp_min(1e-300))
        out.append((c["kernel"], c["name"], gap))
    return out
