"""Tracing, timing and debug aids, the port's counterpart of
ptranking_tpu/utils/profiling.py in PyTorch's idiom:

  * trace(dir): a torch.profiler capture of the enclosed block (the CPU, and
    the card where there is one), written to `dir` as a Chrome trace
    (chrome://tracing or Perfetto).
  * force(value): wait for the device and fetch every tensor leaf of
    `value`, so a wall-clock window closes only when the work is done.
  * StepTimer: wall-clock step timing with the same report keys
    (steps, seconds, steps_per_s, lists_per_s).
  * enable_debug_nans: torch.autograd's anomaly mode, which names the
    forward op whose backward made the first NaN.

The JAX package's `disable_jit` has no counterpart: eager PyTorch runs op by
op already.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; on exit write
    `<log_dir>/trace_<pid>_<ns>.json` (a Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _leaves(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _leaves(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _leaves(v)]
    return []


def force(value) -> float:
    """Wait for everything `value` depends on: synchronise the devices its
    tensors live on, then fetch the sum of EVERY leaf (one leaf alone could
    leave work behind its siblings on another stream). Returns that sum."""
    leaves = _leaves(value)
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return float(sum(float(t.detach().float().sum()) for t in leaves))


class StepTimer:
    """Counts steps/lists and reports throughput.

        timer = StepTimer()
        for batch in batches:
            ...
            timer.step(loss, lists=int(batch.mask.any(-1).sum()))
        print(timer.report())
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self.steps = 0
        self.lists = 0

    def step(self, value=None, lists: int = 0):
        if self._t0 is None:  # first step = warmup boundary
            if value is not None:
                force(value)
            self._t0 = time.perf_counter()
            return
        self.steps += 1
        self.lists += lists

    def report(self, value=None) -> dict:
        if value is not None:
            force(value)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        return {
            "steps": self.steps,
            "seconds": dt,
            "steps_per_s": self.steps / dt if dt > 0 else 0.0,
            "lists_per_s": self.lists / dt if dt > 0 else 0.0,
        }


def enable_debug_nans(on: bool = True):
    """Fault at the op whose backward produces the first NaN
    (torch.autograd.set_detect_anomaly)."""
    torch.autograd.set_detect_anomaly(on)
