"""Predict's static-shape tail as one CUDA graph.

From the sparse encoder's fixed-capacity output (conv_out's sites at the
last capacity: features, zyx coords, mask) to the head's outputs every
shape is fixed by the config, and no step reads a device value on the
host: the dense scatter onto the BEV canvas, SECOND and the FPN on the
fixed maps, the head's DPG and refinements over a fixed number of
proposals (its constants live on the device, `utils/constants.py`).
`SRFDet.forward` runs that tail as one graph where it can observe that a
replay gives what the eager call gives (`SRFDet.tail_graphed`).  Each
frame copies the encoder's output into the graph's static inputs, replays
the graph and hands back copies of its static outputs, so that no frame's
result is overwritten by the next one's.

`TailGraphs` keeps one graph per input signature (shapes, dtypes and
device of the encoder's output).  The first frame of a signature runs the
tail eagerly on a side stream (cuDNN times its algorithms there, outside
the capture), then captures it with `torch.cuda.graph`; those runs record
no span (`profiling.muted`).  A graph reads the parameters and buffers at
their addresses at capture: in-place updates (an optimizer step,
`load_state_dict`) reach the next replay.  It also holds every Python
value its capture read, so a parameter, buffer, submodule or attribute of
a tail module put in another's place (`head.roi_patch = 16`) is found
before the frame's replay and the graph is captured anew; `SRFDet` drops
every graph on `train()` and on `to()` and the other `_apply` calls,
which move tensors in place of others.  One frame at a time: the static
inputs and outputs are shared by every call.

Memory: the graph's private pool holds the tail's intermediates between
frames (reserved memory: `torch.cuda.max_memory_allocated` does not count
it); the static inputs and outputs stay allocated, and nothing else does.

Counters: `tail_graph.captures`, `tail_graph.replays`.
"""

from __future__ import annotations

import operator
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..utils import profiling

# eager runs of the tail on a side stream before its capture
WARMUP_RUNS = 2


class Bindings(NamedTuple):
    """Entries of modules' public attributes, `_parameters`, `_buffers`
    and `_modules` as they were at capture: `tables[i]` held `values[i]`
    under `keys[i]`."""
    tables: Tuple[dict, ...]
    keys: Tuple[str, ...]
    values: tuple

    def hold(self) -> bool:
        """Does every entry still hold the same object?  (~120 us a frame
        for the flagship's ~2,200 entries.)"""
        return all(map(operator.is_, map(dict.get, self.tables, self.keys),
                       self.values))


def bindings(owner: nn.Module, names: Sequence[str]) -> Bindings:
    """Every attribute, parameter, buffer and submodule of `owner`'s
    submodules `names` (what their graph reads), as bound now."""
    out = []
    for name in names:
        top = owner._modules[name]
        out.append((owner._modules, name, top))
        for mod in top.modules():
            attrs = vars(mod)
            out.extend((attrs, key, value) for key, value in attrs.items()
                       if not key.startswith("_"))
            for table in (mod._parameters, mod._buffers, mod._modules):
                out.extend((table, key, value)
                           for key, value in table.items())
    return Bindings(*map(tuple, zip(*out)))


class Captured(NamedTuple):
    graph: object               # torch.cuda.CUDAGraph (replay())
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    bound: Bindings


def capture(fn: Callable, inputs: Sequence[torch.Tensor],
            bound: Bindings) -> Captured:
    """fn(*inputs) as a CUDA graph over static copies of `inputs`."""
    with torch.cuda.device(inputs[0].device), profiling.muted():
        static = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = tuple(fn(*static))
        # cuBLAS keeps a workspace a stream for good: the side stream's
        # and the capture stream's would stay allocated beside the frames
        # (32 MiB each on Hopper).  Freed, the side stream's goes back to
        # the cache and the capture stream's to the graph's own pool,
        # which keeps it for the replays; the current stream's is made
        # again at its next product, as before.
        torch._C._cuda_clearCublasWorkspaces()
    return Captured(graph, static, outputs, bound)


class TailGraphs:
    """The captured graphs of one detector, by input signature."""

    def __init__(self):
        self._graphs: Dict[tuple, Captured] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __reduce__(self):
        # a copy or a pickle of the model starts with no graph
        return TailGraphs, ()

    def clear(self) -> None:
        self._graphs.clear()

    def run(self, fn: Callable, inputs: Sequence[torch.Tensor],
            owner: nn.Module, names: Sequence[str]
            ) -> Tuple[torch.Tensor, ...]:
        """fn(*inputs) (fn runs `owner`'s submodules `names`) by replaying
        its graph, captured on the first call of this signature; returns
        copies of the outputs."""
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        got = self._graphs.get(key)
        if got is not None and not got.bound.hold():
            del self._graphs[key]
            got = None
        if got is None:
            got = self._graphs[key] = capture(fn, inputs,
                                              bindings(owner, names))
            profiling.count("tail_graph.captures")
        for static, t in zip(got.inputs, inputs):
            static.copy_(t)
        got.graph.replay()
        profiling.count("tail_graph.replays")
        return tuple(o.clone() for o in got.outputs)
