"""Data and proposal parallelism on torch.distributed (the `data` and
`model` mesh axes of the JAX package's `parallel/mesh.py`).

The reference trains with one process per GPU, NCCL DDP, all-reduced
SyncBN statistics and reduce_mean loss normalizers (dist_train.sh,
ops/norm.py:9-24, srfdet_head.py:873-884).  The JAX package runs its step
under a `shard_map` over a `data` mesh axis and inserts the same
collectives as `psum_if_sync`; its optional `model` axis is a GSPMD
annotation (`shard_proposal_axis`) that XLA partitions.  Eager PyTorch has
no partitioner: the port runs one process per rank and issues every
collective itself.

The data axis.  Each rank runs on its contiguous slice of the global
batch (`shard_rows`, the `P("data")` sharding), and:

- `all_reduce_sum` sums a tensor over the data group with its gradient
  (the backward all-reduces the incoming gradient, as the reference's
  `AllReduce` does): the BatchNorms' statistics;
- `sum_if_sync` sums outside autograd over the data group: the losses'
  global positive count, the reported metrics;
- `all_reduce_grads` sums the trainable grads once a step, as one flat
  buffer.  A sum, not DDP's mean: each rank's loss already divides by the
  global normalizer.

The model axis.  `make_mesh_2d(n_data, n_model)` splits the world into a
grid: world rank r is data index r // n_model and model index r %
n_model (the model axis is the fast one, as in JAX).  The n_model ranks
of one data index form its model group and hold the same rows; the
n_data ranks of one model index form its data group.  Every data-axis
collective above takes the data group and its size, so a data shard is
counted once, not n_model times.  Inside `proposal_sharding(mesh)` the
head cuts its proposals (`shard_proposal_axis`: model rank m holds the
contiguous block m*n_p/M ... (m+1)*n_p/M - 1) and runs each refinement
iteration on its block alone.  Its cross-proposal steps take the model
group:

- self-attention all-gathers K and V (`gather_proposal_axis` with
  grad="sum": the backward sums the gathered gradient over the model
  group and keeps this rank's block, since every rank's queries attend
  to every key);
- the capacity rules' prefix sums (the patch and xpatch fallback slots,
  the image pair compaction) all-gather the block's counts and add the
  lower ranks' (`proposal_offsets`);
- the outputs of every iteration are gathered at the end of the head
  (grad="slice": the backward keeps this rank's block and issues no
  collective), and the losses, the assignment and decode run on the
  whole set, identically on every model rank.

The gradient.  With the losses L = sum over data shards d of L_d (each
over the global normalizer), model rank m of data index d back-propagates
L_d's cotangent of its own block of outputs only.  Its backward runs
through its block's iterations, through the slice of the initial
proposals (the DPG gets the gradient of its block's rows), through the
RoIAlign of its block's RoIs into the replicated encoder, and through the
K/V gather, whose summed backward hands each rank the cotangent that
every rank's queries put on its keys.  Backward is linear in the
cotangent, so the blocks' backward passes sum to L_d's whole gradient;
the data-group collectives inside it (the BatchNorms' statistics) are
linear in it too.  The step therefore sums the grads over the whole world
(`all_reduce_grads`, told by the head's `mark_cut` that it cut the
proposals): each rank holds its block's share of its data shard's
gradient.  When n_p does not divide by n_model the head runs whole on
every rank (JAX's silent skip) and the grads are summed over the data
group alone; so they are outside the context.

`active()` says whether a group is joined.  Without one, nothing here
issues a collective and every function is the identity, so a
single-process run is unchanged.  A group of size 1 issues every
collective.  Without `make_mesh_2d` the data group is the whole world
(a 1-D group).

Environment (`init_from_env`): torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, or the JAX package's SRFDET_COORD_ADDR
(host:port), SRFDET_NUM_HOSTS and SRFDET_HOST_ID (one process a host).
The backend is NCCL for a CUDA device and gloo for the CPU;
SRFDET_DIST_BACKEND overrides it.  Nothing falls back from one backend to
the other.  Gloo on CUDA tensors: the all-gathers stage through the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKEND_ENV = "SRFDET_DIST_BACKEND"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process grid: its axis names, each axis's size, this rank's index
    along each, and the process group of each axis that holds this rank
    (None: the whole world, or no group joined)."""
    axis_names: Tuple[str, ...]
    n_data: int
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


# the process's mesh (make_mesh_2d), the mesh whose model axis the head
# shards its proposals over (proposal_sharding), and whether the head's
# last forward inside it cut its proposals (mark_cut)
_mesh: Optional[Mesh] = None
_sharding: Optional[Mesh] = None
_cut = False


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
    """Leave the group, when one is joined, and forget the mesh."""
    global _mesh
    _mesh = None
    if active():
        dist.destroy_process_group()


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """The (data, model) grid over a joined group of n_data * n_model
    ranks, made the process's mesh.  World rank r is data index
    r // n_model and model index r % n_model (the model axis is the fast
    one, as in the JAX package).  Every rank creates every data group
    (the ranks of one model index) and every model group (the ranks of
    one data index), in the same order.  Raises when the world is not
    n_data * n_model.  Without a group, a 1 x 1 grid."""
    global _mesh
    if n_data < 1 or n_model < 1 or world() != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the world has "
                         f"{world()}")
    r = rank()
    data_group = model_group = None
    if active():
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if r % n_model == m:
                data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if r // n_model == d:
                model_group = g
    _mesh = Mesh((DATA_AXIS, MODEL_AXIS), n_data, n_model, r // n_model,
                 r % n_model, data_group, model_group)
    return _mesh


def data_group():
    """The process group of the data axis: the mesh's, or the whole world
    (None) without a mesh."""
    return _mesh.data_group if _mesh is not None else None


def data_index() -> int:
    """This rank's index along the data axis (its rank without a mesh)."""
    return _mesh.data_index if _mesh is not None else rank()


def data_size() -> int:
    """The data axis's size (the world's without a mesh)."""
    return _mesh.n_data if _mesh is not None else world()


@contextlib.contextmanager
def proposal_sharding(mesh: Mesh):
    """Shard the head's proposals over `mesh`'s model axis while inside
    (shard_proposal_axis).  Raises on a mesh without a model axis, as the
    JAX package does.  Outside it nothing is sharded."""
    global _sharding, _cut
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{MODEL_AXIS}' "
                         f"axis")
    prev = _sharding, _cut
    _sharding, _cut = mesh, False
    try:
        yield
    finally:
        _sharding, _cut = prev


def sharding() -> Optional[Mesh]:
    """The mesh of the enclosing proposal_sharding, or None."""
    return _sharding


def shards(n: int) -> bool:
    """Whether an axis of n proposals is cut inside the current
    proposal_sharding: a model axis of more than one rank that divides
    n."""
    return _sharding is not None and _sharding.n_model > 1 and \
        n % _sharding.n_model == 0


def mark_cut(cut: bool) -> None:
    """The head records, each forward, whether it cut its proposals
    (`shards`); all_reduce_grads reads it.  Nothing outside
    proposal_sharding."""
    global _cut
    if _sharding is not None:
        _cut = cut


def shard_proposal_axis(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """This model rank's contiguous block of x along `axis` (model rank m:
    m*n/M ... (m+1)*n/M - 1, P(..., "model")'s block order).  x itself
    outside proposal_sharding, on a model axis of one rank, or when the
    axis does not divide by it (the JAX package's silent skip)."""
    mesh = _sharding
    if mesh is None or x.ndim <= axis or not shards(x.shape[axis]):
        return x
    n = x.shape[axis] // mesh.n_model
    return x.narrow(axis, mesh.model_index * n, n)


def _gather_group(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's x over `group`, in its rank order (host-staged for a
    CUDA tensor on gloo)."""
    t = x.detach().contiguous()
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [p.to(x.device) for p in parts] if staged else parts


class _GatherProposals(torch.autograd.Function):
    """All-gather along `axis` over the model group.  Backward, grad "sum":
    the incoming gradient summed over the group (every rank's result
    reaches every rank's loss), this rank's block kept; grad "slice":
    this rank's block of it alone (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, x, axis, grad, mesh):
        ctx.axis, ctx.grad, ctx.mesh = axis, grad, mesh
        ctx.n = x.shape[axis]
        return torch.cat(_gather_group(x, mesh.model_group), axis)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.grad == "sum":
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.model_group)
        return (g.narrow(ctx.axis, mesh.model_index * ctx.n, ctx.n),
                None, None, None)


def gather_proposal_axis(x: torch.Tensor, axis: int = 1, grad: str = "slice",
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """shard_proposal_axis's inverse: the whole axis from every model
    rank's block, in rank order, over `mesh`'s model group (default: the
    enclosing proposal_sharding's).  `grad`: "slice" (every model rank
    computes the same loss of the result) or "sum" (each rank's own
    function of it).  x itself without a sharding mesh of more than one
    model rank."""
    mesh = mesh or _sharding
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad {grad!r}: 'slice' or 'sum'")
    if mesh is None or mesh.n_model == 1:
        return x
    return _GatherProposals.apply(x, axis, grad, mesh)


@torch.no_grad()
def proposal_offsets(counts: torch.Tensor, mesh: Optional[Mesh] = None
                     ) -> torch.Tensor:
    """The exclusive prefix of `counts` (a row of per-sample counts of this
    rank's block, integer) over the model group: what the lower model
    ranks' blocks hold before this rank's, row by row.  Zeros without a
    sharding mesh of more than one model rank."""
    mesh = mesh or _sharding
    if mesh is None or mesh.n_model == 1:
        return torch.zeros_like(counts)
    every = _gather_group(counts.long(), mesh.model_group)
    return sum(every[:mesh.model_index], torch.zeros_like(counts.long()))


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
        dist.all_reduce(out, group=data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=data_group())
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data group, differentiable (its gradient is summed
    over the data group too); x itself without a group."""
    return _AllReduceSum.apply(x) if active() else x


@torch.no_grad()
def sum_if_sync(x: torch.Tensor) -> torch.Tensor:
    """A sum over the data group outside autograd (normalizers, reported
    metrics); x itself without a group."""
    if not active():
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=data_group())
    return out


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' .grad as one flat buffer, in place (a missing
    grad counts as zeros and is set): over the whole world when the
    head's last forward inside proposal_sharding cut its proposals
    (mark_cut: each rank holds its block's share), else over the data
    group.  Nothing without a group."""
    if not active():
        return
    params = list(params)
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                      else torch.zeros(p.numel(), device=p.device)
                      for p in params])
    whole = _sharding is not None and _cut
    dist.all_reduce(flat, group=None if whole else data_group())
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


def shard_rows(batch, rank_: Optional[int] = None,
               world_: Optional[int] = None):
    """Rank `rank_`'s contiguous rows of a global batch (the `P("data")`
    sharding): rows r*B/W ... (r+1)*B/W - 1 of every leading axis.  Takes
    a dict of arrays or tensors, or one array; B must divide by W.  By
    default r and W are the data index and the data size."""
    if rank_ is None:
        rank_ = data_index()
    if world_ is None:
        world_ = data_size()
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

