"""Device-resident dataset: upload once, gather every batch on the device.

The port's copy of ptranking_tpu/data/device_cache.py (its lines 1-243; the
diversification twin waits for that branch). A streamed epoch copies every
batch host->device; the dataset is the same every epoch and only the batch
order changes. So each bucket's padded arrays go to the device once, and a
batch is an `index_select` of its rows there: an epoch copies only the
[k, B] int64 index arrays of its batch schedule.

Each bucket gets one all-masked sentinel row at index Q; a remainder batch
is padded with it, which is what BucketedDataset.batches' padded remainders
hold. The schedule comes from the same `np.random.RandomState(seed + epoch)`
draws, so the batches equal the streamed dataset's for every
(shuffle, epoch, drop_remainder, percent).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.dataset import BucketedDataset
from ptranking_tpu_torch.types import RankingBatch

DEFAULT_BUDGET_BYTES = 1 << 30


class QuantFeats(NamedTuple):
    """int8 resident features: data [Q+1, N, F] int8 with a per-feature
    affine dequantisation, x ~= data * scale + offset (scale, offset [F]
    fp32). A quarter of fp32's bytes; the error is at most (max-min)/508
    a feature."""

    data: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor


def quantize_features(feats: np.ndarray, mask: np.ndarray, device="cuda") -> QuantFeats:
    """Per-feature affine int8 quantisation over the real (masked-in)
    entries; padded slots land in whatever bin 0 falls in (they are masked
    downstream). A non-finite real value raises: it would wipe out its whole
    column."""
    real = mask[..., None]
    big = np.float32(np.inf)
    lo = np.where(real, feats, big).min(axis=(0, 1)).astype(np.float32)
    hi = np.where(real, feats, -big).max(axis=(0, 1)).astype(np.float32)
    if np.asarray(mask).any():
        bad = ~(np.isfinite(lo) & np.isfinite(hi))
        if bad.any():
            raise ValueError(
                f"int8 residency: feature columns {np.nonzero(bad)[0].tolist()} contain "
                "non-finite values; clean the data or use fp32/bf16 device_resident_dtype")
    else:  # no real entries at all: quantize the zeros trivially
        lo = np.zeros_like(lo)
        hi = np.zeros_like(hi)
    scale = np.maximum(hi - lo, 1e-12) / 254.0
    offset = (hi + lo) / 2.0
    q = np.clip(np.rint((feats - offset) / scale), -127, 127).astype(np.int8)
    dev = torch.device(device)
    return QuantFeats(torch.from_numpy(q).to(dev), torch.from_numpy(scale).to(dev),
                      torch.from_numpy(offset).to(dev))


def _n_rows(feats) -> int:
    """Row count, the sentinel included, of dense or QuantFeats features."""
    return (feats.data if isinstance(feats, QuantFeats) else feats).shape[0]


def take_features(feats, idx: torch.Tensor) -> torch.Tensor:
    """Batch rows `idx` of resident features: an index_select on the device;
    int8 rows are dequantised to fp32 after the gather (the scorer casts to
    its compute dtype on entry)."""
    if isinstance(feats, QuantFeats):
        q = feats.data.index_select(0, idx)
        return q.float() * feats.scale + feats.offset
    return feats.index_select(0, idx)


def padded_host_arrays(ds: BucketedDataset, bucket: int):
    """One bucket's packed host arrays with the all-masked sentinel row
    appended at index Q: the layout the resident paths gather from."""
    feats, labels, mask, _ = ds._packed[bucket]
    f = np.concatenate([feats, np.zeros_like(feats[:1])], axis=0)
    l = np.concatenate([labels, np.zeros_like(labels[:1])], axis=0)
    m = np.concatenate([mask, np.zeros_like(mask[:1])], axis=0)
    return f, l, m


def packed_nbytes(ds: BucketedDataset, dtype=None) -> int:
    """Device bytes the dataset's packed arrays take, the features at `dtype`
    when given (bfloat16 halves the largest term)."""
    total = 0
    for feats, labels, mask, _ in ds._packed.values():
        f_bytes = feats.nbytes
        if dtype is not None:
            f_bytes = feats.size * np.dtype(
                np.float16 if str(dtype) in ("bfloat16", "float16") else dtype).itemsize
        total += f_bytes + labels.nbytes + mask.nbytes
    return total


def _device_features(f: np.ndarray, m: np.ndarray, dtype, device):
    if str(dtype) == "int8":
        return quantize_features(f, m.astype(bool), device)
    t = torch.from_numpy(f)
    if dtype is not None:
        # cast on the host: the upload moves the smaller type and the device
        # never holds a transient fp32 copy
        t = t.to(getattr(torch, str(dtype)))
    return t.to(device)


class DeviceResidentDataset:
    """A BucketedDataset whose packed arrays live on `device`; its batches are
    gathered there. The same batches, in the same order, as the wrapped
    dataset for the same (shuffle, epoch, drop_remainder, percent)."""

    def __init__(self, ds: BucketedDataset, dtype=None, device="cuda"):
        self.ds = ds
        self.device = resolve_device(device)
        self.num_queries = ds.num_queries
        self.buckets = ds.buckets
        self.batch_docs = ds.batch_docs
        self._dev = {}
        for b, (_, _, _, qids) in ds._packed.items():
            f, l, m = padded_host_arrays(ds, b)
            self._dev[b] = (_device_features(f, m, dtype, self.device),
                            torch.from_numpy(l).to(self.device),
                            torch.from_numpy(m).to(self.device), qids)

    def batch_size_for(self, bucket: int) -> int:
        return self.ds.batch_size_for(bucket)

    def qid_for(self, batch: RankingBatch, row: int):
        return self.ds.qid_for(batch, row)

    def index_to_device(self, idx: np.ndarray) -> torch.Tensor:
        """One host->device copy of an int64 index array (pinned and
        asynchronous on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _gather(self, bucket: int, idx: torch.Tensor):
        feats, labels, mask, _ = self._dev[bucket]
        return (take_features(feats, idx), labels.index_select(0, idx),
                mask.index_select(0, idx))

    def batches(self, shuffle: bool = False, epoch: int = 0, drop_remainder: bool = False,
                percent: Optional[float] = None) -> Iterator[RankingBatch]:
        """BucketedDataset.batches' contract (the same draws), with features,
        labels and mask gathered on the device."""
        rng = np.random.RandomState(self.ds.seed + epoch)
        for b in self._dev:
            feats, _, _, qids = self._dev[b]
            sentinel = _n_rows(feats) - 1  # the all-masked pad row
            Q = sentinel
            B = self.batch_size_for(b)
            idx = rng.permutation(Q) if (shuffle or percent) else np.arange(Q)
            if percent is not None:
                if not 0.0 < percent <= 1.0:
                    raise ValueError(f"percent must be in (0, 1], got {percent}")
                idx = idx[: max(1, int(Q * percent))]
                Q = len(idx)
            n_full = Q // B
            for i in range(n_full):
                sl = idx[i * B:(i + 1) * B]
                yield RankingBatch(*self._gather(b, self.index_to_device(sl)), qids[sl])
            rem = Q - n_full * B
            if rem and not drop_remainder:
                sl = idx[n_full * B:]
                # the sentinel fills the padded tail (not the post-percent Q,
                # which would gather a real query's row)
                sl_pad = np.full((B,), sentinel, np.int64)
                sl_pad[:rem] = sl
                qi = np.full((B,), -1, np.int32)
                qi[:rem] = qids[sl]
                yield RankingBatch(*self._gather(b, self.index_to_device(sl_pad)), qi)

    def epoch_index_chunks(self, shuffle: bool = False, epoch: int = 0, chunk_size: int = 8):
        """(bucket, idx [k, B] int64, real queries) chunks covering the batch
        schedule of batches(shuffle, epoch), k <= chunk_size. A remainder
        batch is an index row padded with the sentinel."""
        rng = np.random.RandomState(self.ds.seed + epoch)
        for b in self._dev:
            Q = _n_rows(self._dev[b][0]) - 1
            B = self.batch_size_for(b)
            idx = rng.permutation(Q) if shuffle else np.arange(Q)
            n_full = Q // B
            rows = [idx[i * B:(i + 1) * B] for i in range(n_full)]
            real = [B] * n_full
            rem = Q - n_full * B
            if rem:
                pad = np.full((B,), Q, np.int64)
                pad[:rem] = idx[n_full * B:]
                rows.append(pad)
                real.append(rem)
            for lo in range(0, len(rows), chunk_size):
                sub = rows[lo:lo + chunk_size]
                yield b, np.stack(sub).astype(np.int64), int(sum(real[lo:lo + chunk_size]))

    def bucket_arrays(self, bucket: int):
        """(features, labels, mask) on the device for one bucket, the sentinel
        row included."""
        return self._dev[bucket][:3]

    def __len__(self):
        return len(self.ds)


def maybe_device_resident(ds: BucketedDataset, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                          dtype=None, device="cuda"):
    """A DeviceResidentDataset when the packed arrays (features at `dtype`)
    fit `budget_bytes`, else `ds` itself (streamed every epoch)."""
    if packed_nbytes(ds, dtype) <= budget_bytes:
        return DeviceResidentDataset(ds, dtype=dtype, device=device)
    return ds
