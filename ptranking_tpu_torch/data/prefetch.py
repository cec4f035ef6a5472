"""Background prefetch of streamed batches onto the device, and the
process group's bring-up.

The port's counterpart of ptranking_tpu/data/prefetch.py.
`prefetch_to_device` is the evaluator's streamed path, taken when a dataset
exceeds the device-resident budget: a bounded background thread stages the
next batches into pinned host memory and copies them to the device with
`non_blocking=True`, so batch assembly and the copies overlap the running
step. `shard_for_process` gives a rank its strided share of a query
stream; `initialize_distributed` makes the torch.distributed process group
that the mesh is built on (under torchrun, from its environment).
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from ptranking_tpu_torch.parallel import launch
from ptranking_tpu_torch.types import RankingBatch

T = TypeVar("T")

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


def shard_for_process(items: Sequence[T], process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> Sequence[T]:
    """This rank's slice of a query stream (strided, so label and length
    distributions stay balanced across ranks). The rank and the world size
    default to the process group's (0 and 1 without one)."""
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    return items[pi::pc]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device_type: Optional[str] = None) -> bool:
    """The default process group, made once: from the arguments when given,
    else from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; a CUDA rank takes card LOCAL_RANK). The backend follows the
    run's device type: NCCL for cuda, gloo otherwise (by default cuda where
    CUDA is available). Returns True when the group has more than one rank;
    a single process without a launcher gets no group and False."""
    if not (dist.is_available() and dist.is_initialized()):
        explicit = init_method is not None or (world_size or 1) > 1
        if not explicit and "RANK" not in os.environ:
            return False
        device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
        dist.init_process_group(launch.backend_for(device_type),
                                init_method=init_method or "env://",
                                world_size=world_size if world_size is not None else -1,
                                rank=rank if rank is not None else -1,
                                timeout=datetime.timedelta(seconds=launch.DEFAULT_TIMEOUT_S))
    return dist.get_world_size() > 1
