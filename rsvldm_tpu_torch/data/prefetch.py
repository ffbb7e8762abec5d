"""The input pipeline (rsvldm_tpu/data/prefetch.py): the
DataLoader(num_workers, pin_memory) counterpart.

- `worker_map`: an order-preserving threaded map over dataset items. PIL
  decode and NumPy copies release the GIL, so threads overlap them without
  pickling the dataset. Futures are consumed in submission order, so the
  worker count changes throughput, never the stream.
- `prefetch_to_device`: a thread that stages the next `size` batches on the
  device: each array goes to pinned host memory and is copied with
  non_blocking on a side CUDA stream; the consumer's stream waits for that
  copy's event, so batch N+1's copy overlaps step N. The device is CUDA
  unless the caller passes device="cpu" (then the arrays become tensors and
  nothing is copied); without a card the default raises.
- `make_loader`: shuffled epochs of an indexable dataset through both.

A worker's exception reaches the consumer; threads stop on close().
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device


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


class _Closed(Exception):
    pass


class prefetch_to_device:
    """Wrap an iterator of tuples of numpy arrays so that the next `size`
    are already tensors on `device` (default CUDA) when the consumer
    asks."""

    _SENTINEL = object()

    def __init__(self, it: Iterable[Any], size: int = 2, device=None):
        self._closed = threading.Event()  # first: __del__ reads it
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, size))
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _stage(self, batch):
        if self._stream is None:
            return tuple(torch.from_numpy(np.asarray(a)) for a in batch), None
        with torch.cuda.stream(self._stream):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        .to(self.device, non_blocking=True) for a in batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> None:
        # a bounded put that gives up promptly once the consumer closes
        while True:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                if self._closed.is_set():
                    raise _Closed

    def _run(self, it: Iterator[Any]) -> None:
        try:
            for batch in it:
                if self._closed.is_set():
                    return
                self._put(self._stage(batch))
        except _Closed:
            return
        except BaseException as e:  # reaches the consumer
            self._err = e
        try:
            self._put(self._SENTINEL)
        except _Closed:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    item = self._SENTINEL
                    break
        if item is self._SENTINEL:
            self.close()
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in batch:  # the consumer's stream now owns the memory
                t.record_stream(cur)
        return batch

    def close(self):
        self._closed.set()

    def __del__(self):
        self.close()


def make_loader(dataset, batch_size: int, *, num_workers: int = 4,
                prefetch: int = 2, device=None, seed: int = 0,
                drop_last: bool = True, epochs: int | None = None,
                rows: tuple[int, int] | None = None):
    """Shuffled epochs (random.Random(seed)) of an indexable dataset:
    items fetched by worker_map, stacked per column on the host, staged on
    `device` (default CUDA) by prefetch_to_device. Batches never span a reshuffle; with
    drop_last an epoch's remainder is dropped. When the dataset has
    getitem_rng(idx, rng), each fetch gets random.Random(f"{seed}/{epoch}/
    {idx}"), so augmentation does not depend on the worker count.
    epochs=None streams forever. JAX's loader gives the same batches.
    rows=(start, stop): fetch only those rows of every global batch of
    `batch_size` (a data-parallel rank's share, parallel/distributed.
    local_batch_range); with drop_last only."""
    seeded = getattr(dataset, "getitem_rng", None)

    def fetch(key):
        epoch, idx = key
        if seeded is not None:
            return seeded(idx, random.Random(f"{seed}/{epoch}/{idx}"))
        return dataset[idx]

    if rows is not None and not drop_last:
        raise ValueError("make_loader: rows= needs drop_last")
    lo, hi = rows if rows is not None else (0, batch_size)
    global_batch = batch_size
    full = len(dataset) // global_batch * global_batch

    def keep(j: int) -> bool:
        return rows is None or (j < full and lo <= j % global_batch < hi)

    def indices():
        rng = random.Random(seed)
        order = list(range(len(dataset)))
        epoch = 0
        while epochs is None or epoch < epochs:
            rng.shuffle(order)
            yield from ((epoch, i) for j, i in enumerate(order) if keep(j))
            epoch += 1

    per_epoch = len(dataset) if rows is None else full // global_batch * (hi - lo)
    batch_size = hi - lo

    def batches():
        buf = []
        for pos, item in enumerate(worker_map(fetch, indices(),
                                              num_workers=num_workers)):
            buf.append(item)
            if len(buf) == batch_size:
                yield tuple(np.stack(col) for col in zip(*buf))
                buf = []
            if (pos + 1) % per_epoch == 0:  # reshuffle boundary
                if buf and not drop_last:
                    yield tuple(np.stack(col) for col in zip(*buf))
                buf = []

    return prefetch_to_device(batches(), size=prefetch, device=device)
