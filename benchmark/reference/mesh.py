"""One process, no process group: what the port's `parallel.mesh` does
outside a group (every reduction is the identity, nothing is sharded)."""

from __future__ import annotations

Mesh = object


def active() -> bool:
    return False


def data_index() -> int:
    return 0


def shards(n: int) -> bool:
    return False


def sharding():
    return None


def mark_cut(cut: bool) -> None:
    pass


def all_reduce_sum(x):
    return x


def sum_if_sync(x):
    return x


def all_reduce_grads(params) -> None:
    pass
