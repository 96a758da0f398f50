"""Data parallelism on torch.distributed (the data axis of the JAX
package's `parallel/mesh.py`).

The reference trains with one process per GPU, NCCL DDP, all-reduced
SyncBN statistics and reduce_mean loss normalizers (dist_train.sh,
ops/norm.py:9-24, srfdet_head.py:873-884).  The JAX package runs its step
under a `shard_map` over a `data` mesh axis and inserts the same
collectives as `psum_if_sync`.  The port runs one process per rank, each on
its contiguous slice of the global batch (`shard_rows`, the `P("data")`
sharding), and issues the collectives itself:

- `all_reduce_sum` sums a tensor over the ranks with its gradient (the
  backward all-reduces the incoming gradient, as the reference's
  `AllReduce` does): the BatchNorms' statistics;
- the losses divide each rank's local sums by the global positive count;
- `all_reduce_grads` sums the trainable grads once a step, as one flat
  buffer.  A sum, not DDP's mean: each rank's loss already divides by the
  global normalizer.

`active()` says whether a group is joined.  Without one, nothing here
issues a collective and every function is the identity, so a
single-process run is unchanged.  A group of size 1 issues every
collective.

The JAX package's optional `model` axis (proposal sharding,
`make_mesh_2d`, `proposal_sharding`, `shard_proposal_axis`) has no port.

Environment (`init_from_env`): torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, or the JAX package's SRFDET_COORD_ADDR
(host:port), SRFDET_NUM_HOSTS and SRFDET_HOST_ID (one process a host).
The backend is NCCL for a CUDA device and gloo for the CPU;
SRFDET_DIST_BACKEND overrides it.  Nothing falls back from one backend to
the other.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKEND_ENV = "SRFDET_DIST_BACKEND"


def active() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def env_ranks() -> Optional[Tuple[int, int, int, str]]:
    """(rank, world, local rank, init_method) from torchrun's variables or,
    failing those, from SRFDET_COORD_ADDR / SRFDET_NUM_HOSTS /
    SRFDET_HOST_ID; None when the environment names no group."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)), "env://")
    coord = env.get("SRFDET_COORD_ADDR")
    if coord:
        return (int(env.get("SRFDET_HOST_ID", "0")),
                int(env.get("SRFDET_NUM_HOSTS", "1")), 0, f"tcp://{coord}")
    return None


def rank_device(device=None) -> torch.device:
    """The device this process runs on: `device` when the caller names one;
    else cuda:LOCAL_RANK when the environment names a group (one process a
    card), else cuda.  Raises when CUDA is asked for and there is none."""
    from .. import resolve_device
    ranks = env_ranks()
    if device is None and ranks is not None:
        device = f"cuda:{ranks[2]}"
    return resolve_device(device)


def backend_for(device: torch.device) -> str:
    """SRFDET_DIST_BACKEND when set, else nccl for CUDA and gloo for the
    CPU."""
    chosen = os.environ.get(BACKEND_ENV)
    if chosen:
        return chosen
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device: torch.device,
                  timeout_s: float = 1800.0) -> bool:
    """Join the group the environment names (env_ranks), on the backend
    `backend_for(device)` gives; CUDA ranks first make `device` current.
    Returns False, and joins nothing, when the environment names no
    group.  Raises when a group is already joined."""
    ranks = env_ranks()
    if ranks is None:
        return False
    if active():
        raise RuntimeError("a process group is already initialized")
    r, w, _, method = ranks
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method=method, world_size=w, rank=r,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the group, when one is joined."""
    if active():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where this module puts the host's small tensors for a collective:
    the current card for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradient over
    the ranks (reference ops/norm.py:9-24)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiable (its gradient is summed over
    the ranks too); x itself without a group."""
    return _AllReduceSum.apply(x) if active() else x


@torch.no_grad()
def sum_if_sync(x: torch.Tensor) -> torch.Tensor:
    """A sum over the ranks outside autograd (normalizers, reported
    metrics); x itself without a group."""
    if not active():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' .grad over the ranks as one flat buffer, in
    place (a missing grad counts as zeros and is set).  Nothing without a
    group."""
    if not active():
        return
    params = list(params)
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                      else torch.zeros(p.numel(), device=p.device)
                      for p in params])
    dist.all_reduce(flat)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        if p.grad is None:
            p.grad = g.view_as(p).clone()
        else:
            p.grad.copy_(g.view_as(p))


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place.  Nothing without
    a group."""
    if not active():
        return
    for t in tensors:
        dist.broadcast(t, src)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers on every rank, so that the
    ranks start bit-identical."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()),
                      src)


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank (a signal that
    reached one rank only); `flag` itself without a group."""
    if not active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if active():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def shard_rows(batch, rank_: int, world_: int):
    """Rank `rank_`'s contiguous rows of a global batch (the `P("data")`
    sharding): rows r*B/W ... (r+1)*B/W - 1 of every leading axis.  Takes
    a dict of arrays or tensors, or one array; B must divide by W."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, rank_, world_) for k, v in batch.items()}
    b = batch.shape[0]
    if b % world_:
        raise ValueError(f"batch dim {b} not divisible by {world_} ranks")
    n = b // world_
    return batch[rank_ * n:(rank_ + 1) * n]


def gather_rows(rows: Dict[str, np.ndarray]) -> Tuple[
        Dict[str, np.ndarray], np.ndarray]:
    """All-gather each rank's (n_r, ...) arrays as fixed-shape (W, n_max,
    ...) arrays, each rank's rows padded with zeros to the largest n_r,
    in process-major order, with the (W, n_max) `frame_ok` mask of real
    rows.  Every rank passes the same keys with the same trailing shapes
    and dtypes."""
    n_local = next(iter(rows.values())).shape[0]
    dev = _comm_device()
    w = world()
    counts = torch.tensor([n_local], dtype=torch.int64, device=dev)
    every = [torch.empty_like(counts) for _ in range(w)]
    dist.all_gather(every, counts)
    n_all = [int(c.item()) for c in every]
    n_max = max(n_all)
    out = {}
    for k, v in rows.items():
        v = np.asarray(v)
        is_bool = v.dtype == np.bool_
        pad = np.zeros((n_max - n_local,) + v.shape[1:], v.dtype)
        arr = np.ascontiguousarray(np.concatenate([v, pad]))
        # collectives take no bool tensors: gather the bytes
        t = torch.from_numpy(arr.view(np.uint8) if is_bool else arr).to(dev)
        parts = [torch.empty_like(t) for _ in range(w)]
        dist.all_gather(parts, t)
        g = torch.stack(parts).cpu().numpy()
        out[k] = g.view(np.bool_) if is_bool else g
    ok = np.zeros((w, n_max), bool)
    for r, n in enumerate(n_all):
        ok[r, :n] = True
    return out, ok


def strided_order(gathered: Dict[str, np.ndarray], ok: np.ndarray
                  ) -> Dict[str, np.ndarray]:
    """The rows of gather_rows in dataset order, when rank r held dataset
    items r, r + W, r + 2W, ... (the strided shards of multi-process eval):
    item g is rank g % W's row g // W (the reference's collect_results
    interleave)."""
    keep = ok.T.reshape(-1)
    return {k: np.swapaxes(v, 0, 1).reshape((-1,) + v.shape[2:])[keep]
            for k, v in gathered.items()}

