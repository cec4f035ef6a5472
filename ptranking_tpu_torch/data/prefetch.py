"""Background prefetch of streamed batches onto the device.

The port's counterpart of ptranking_tpu/data/prefetch.py::prefetch_to_device
(`shard_for_process` waits for the multi-device layer). The evaluator's
streamed path, taken when a dataset exceeds the device-resident budget: a
bounded background thread stages the next batches into pinned host memory
and copies them to the device with `non_blocking=True`, so batch assembly
and the copies overlap the running step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ptranking_tpu_torch.types import RankingBatch

_STOP = object()


def _stage(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        # the caching host allocator keeps the pinned block until the copy ends
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(batches: Iterable[RankingBatch], size: int = 2,
                       device="cuda") -> Iterator[RankingBatch]:
    """Yield the batches of `batches` with features, labels and mask already
    on `device` (labels fp32, mask bool). A daemon thread stages up to `size`
    batches ahead in a bounded queue; an exception in it is raised at the
    consumer, and the thread stops when the consumer drops the generator."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    abandoned = threading.Event()

    def stage(b: RankingBatch) -> RankingBatch:
        return RankingBatch(_stage(b.features, device), _stage(b.labels, device, torch.float32),
                            _stage(b.mask, device, torch.bool), b.qids)

    def put_or_bail(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so the
        # thread and its staged batches cannot leak
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not put_or_bail(stage(b)):
                    return
        except BaseException as exc:  # surfaced in the consumer's thread
            put_or_bail(exc)
            return
        put_or_bail(_STOP)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()  # also on GeneratorExit and an early break
