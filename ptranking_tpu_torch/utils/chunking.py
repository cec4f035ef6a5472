"""Same-shape batch chunking for the passes that check the host once a chunk.

The port's copy of ptranking_tpu/utils/chunking.py. The JAX package fuses a
full chunk of `chunk_size` same-shape batches into one dispatch and runs
bucket boundaries and epoch tails one step at a time; the port steps every
batch eagerly, and the chunk is where a pass waits for the device (the
adversarial passes' non-finite check, once a chunk, at the JAX package's
boundaries)."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Tuple


def iter_shape_chunks(
    batches: Iterable,
    chunk_size: int,
    shape_of: Callable = lambda b: b.features.shape,
) -> Iterator[Tuple[List, bool]]:
    """Yield (chunk, fused) pairs. `fused` is True only for full
    `chunk_size`-sized same-shape chunks (and only when chunk_size > 1);
    boundary/tail chunks come out with fused=False for per-step execution."""
    chunk_size = max(int(chunk_size), 1)
    pending: List = []
    last_shape = None
    for b in batches:
        s = shape_of(b)
        if pending and s != last_shape:
            yield pending, False  # bucket boundary
            pending = []
        pending.append(b)
        last_shape = s
        if len(pending) >= chunk_size:
            yield pending, chunk_size > 1
            pending = []
    if pending:
        yield pending, False  # epoch tail
