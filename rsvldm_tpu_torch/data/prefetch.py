"""Order-preserving threaded map over dataset items
(rsvldm_tpu/data/prefetch.py:39, `worker_map`): the DataLoader(num_workers)
counterpart for host-side record decoding. PIL decode and NumPy copies
release the GIL, so threads overlap them without pickling the dataset.
Futures are consumed in submission order, so the worker count changes
throughput, never the stream; a worker's exception reaches the consumer."""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator


def worker_map(fn: Callable[[Any], Any], items: Iterable[Any],
               num_workers: int = 4, inflight: int | None = None) -> Iterator[Any]:
    """Map fn over items with a thread pool, yielding in order with at most
    `inflight` (default 2 * num_workers) items computed ahead of the
    consumer; num_workers <= 0 maps inline."""
    if num_workers <= 0:
        for it in items:
            yield fn(it)
        return
    inflight = inflight or 2 * num_workers
    it = iter(items)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        n_pending = 0
        exhausted = False
        while True:
            while not exhausted and n_pending < inflight:
                try:
                    pending.put(pool.submit(fn, next(it)))
                    n_pending += 1
                except StopIteration:
                    exhausted = True
            if n_pending == 0:
                return
            yield pending.get().result()
            n_pending -= 1
