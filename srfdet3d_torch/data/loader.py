"""Batched data iteration with background prefetch (a copy of the JAX
package's `data/loader.py`).

Replaces the reference's torch DataLoader workers (mmcv runner [dep]): a
thread pool maps the numpy pipeline over shuffled indices and a small queue
overlaps host preprocessing with device steps.  Samples are fixed-shape, so
collation is a plain stack and device transfer is one contiguous copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..parallel.mesh import shard_rows
from .datasets import collate_batch


def data_loader(dataset,
                batch_size: int,
                shuffle: bool = True,
                seed: int = 0,
                num_workers: int = 4,
                prefetch: int = 2,
                drop_last: bool = True,
                skip_batches: int = 0,
                shard: Optional[Tuple[int, int]] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields collated numpy batches; runs one epoch.

    skip_batches: start at that batch of the (seed-deterministic) order
    WITHOUT materializing the skipped samples — mid-epoch resume
    (the train CLI's preemption resume) must not reprocess the epoch prefix
    through the augmentation pipeline.

    shard: (rank, world) of a data-parallel run: every batch is rank's
    rows of the global batch of `batch_size` in the same order
    (`shard_rows`); only those samples are materialized.  A sample's
    augmentation draws depend on its index alone, so the rows equal the
    global batch's."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    first = min(max(skip_batches, 0), n_batches)
    if n_batches == first:
        return

    def indices(b):
        idxs = order[b * batch_size:(b + 1) * batch_size]
        return idxs if shard is None else shard_rows(idxs, *shard)

    if num_workers <= 0:
        for b in range(first, n_batches):
            yield collate_batch([dataset[int(i)] for i in indices(b)])
        return

    # maxsize=0 would mean UNBOUNDED (whole-epoch host blowup)
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that honors stop (no deadlock on abandonment)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(num_workers) as pool:
                for b in range(first, n_batches):
                    if stop.is_set():
                        return
                    samples = list(pool.map(
                        lambda i: dataset[int(i)], indices(b)))
                    if not put(collate_batch(samples)):
                        return
        except BaseException as e:          # propagate to the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
