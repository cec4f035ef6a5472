"""Fixed-width padded buckets of query lists, and synthetic LETOR queries (numpy).

The port's own copy of ptranking_tpu/data/dataset.py: every query is padded
up to the smallest bucket width that holds it, and each bucket yields batches
of one fixed [B, N, F] shape, so the same queries give the same batches in
the same order as the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ptranking_tpu_torch.data.letor import Query, np_shuffle_ties_argsort
from ptranking_tpu_torch.types import RankingBatch

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 1536)


def geometric_buckets(growth: float = 2.0, start: int = 16,
                      cap: int = 1536) -> Tuple[int, ...]:
    """Bucket widths growing by `growth`, rounded up to multiples of 8."""
    bs = [start]
    while bs[-1] < cap:
        nxt = max(bs[-1] + 8, int(math.ceil(bs[-1] * growth / 8) * 8))
        bs.append(min(nxt, cap))
    return tuple(bs)


def pick_buckets(sizes: Sequence[int], buckets: Sequence[int] = DEFAULT_BUCKETS,
                 growth: float = 2.0) -> List[int]:
    """Keep only the buckets needed for the observed list sizes."""
    buckets = sorted(buckets)
    if not sizes:
        return [buckets[0]]
    mx = max(sizes)
    while buckets[-1] < mx:
        buckets.append(max(buckets[-1] + 8,
                           int(math.ceil(buckets[-1] * growth / 8) * 8)))
    needed = set()
    for s in sizes:
        needed.add(next(b for b in buckets if b >= s))
    return sorted(needed)


class BucketedDataset:
    """Pads per-query lists into per-bucket arrays; yields RankingBatch.

    A batch from bucket N holds about batch_docs/N queries (at least 1), so
    every bucket has one fixed batch shape.
    """

    def __init__(
        self,
        queries: Sequence[Query],
        batch_docs: int = 2048,
        buckets: Optional[Sequence[int]] = None,
        num_features: Optional[int] = None,
        max_list_size: Optional[int] = None,
        seed: int = 137,
        bucket_growth: float = 2.0,
    ):
        self.seed = seed
        sizes = [len(q[2]) for q in queries]
        if max_list_size is not None:
            sizes = [min(s, max_list_size) for s in sizes]
        if buckets is None:
            buckets = (DEFAULT_BUCKETS if bucket_growth == 2.0
                       else geometric_buckets(bucket_growth))
        self.buckets = pick_buckets(sizes, buckets, growth=bucket_growth)
        self.num_features = num_features or (queries[0][1].shape[1] if queries else 0)
        self.batch_docs = batch_docs
        self._by_bucket: dict = {b: [] for b in self.buckets}
        self.num_queries = 0
        for qid, f, l in queries:
            n = len(l)
            if max_list_size is not None and n > max_list_size:
                f, l, n = f[:max_list_size], l[:max_list_size], max_list_size
            b = next(x for x in self.buckets if x >= n)
            self._by_bucket[b].append((qid, f, l))
            self.num_queries += 1
        # pack each bucket into contiguous padded arrays once
        self._packed = {}
        for b, items in self._by_bucket.items():
            if not items:
                continue
            Q = len(items)
            feats = np.zeros((Q, b, self.num_features), np.float32)
            labels = np.zeros((Q, b), np.float32)
            mask = np.zeros((Q, b), bool)
            qids = np.arange(Q, dtype=np.int32)
            for i, (_, f, l) in enumerate(items):
                n = len(l)
                # a sparse parse may fall short of the declared width (absent
                # trailing columns stay 0); wider than declared is an error
                if f.shape[1] > self.num_features:
                    raise ValueError(
                        f"query has feature id {f.shape[1]} > declared "
                        f"num_features={self.num_features}; fix the data "
                        f"meta / JSON num_features")
                w = f.shape[1]
                feats[i, :n, :w] = f[:, :w]
                labels[i, :n] = l
                mask[i, :n] = True
            self._packed[b] = (feats, labels, mask, qids)
        self._qid_strs = {b: [it[0] for it in items] for b, items in self._by_bucket.items()}

    def batch_size_for(self, bucket: int) -> int:
        """One fixed batch size per bucket: batch_docs padded slots, rounded."""
        return max(1, round(self.batch_docs / bucket))

    def batches(self, shuffle: bool = False, epoch: int = 0, drop_remainder: bool = False,
                percent: Optional[float] = None) -> Iterator[RankingBatch]:
        """Yield fixed-shape batches. The remainder of each bucket is padded
        with all-masked queries up to the fixed batch size (never dropped by
        default). `percent` in (0, 1] samples that fraction of each bucket's
        queries per epoch."""
        rng = np.random.RandomState(self.seed + epoch)
        for b in list(self._packed.keys()):
            feats, labels, mask, qids = self._packed[b]
            Q = feats.shape[0]
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
                yield RankingBatch(feats[sl], labels[sl], mask[sl], qids[sl])
            rem = Q - n_full * B
            if rem and not drop_remainder:
                sl = idx[n_full * B:]
                f = np.zeros((B, b, self.num_features), np.float32)
                l = np.zeros((B, b), np.float32)
                m = np.zeros((B, b), bool)
                qi = np.full((B,), -1, np.int32)
                f[:rem], l[:rem], m[:rem], qi[:rem] = feats[sl], labels[sl], mask[sl], qids[sl]
                yield RankingBatch(f, l, m, qi)

    def qid_for(self, batch: RankingBatch, row: int) -> Optional[str]:
        """The qid string behind `batch` row `row`, or None for an all-padded
        remainder row."""
        idx = int(np.asarray(batch.qids)[row])
        if idx < 0:
            return None
        bucket = batch.features.shape[1]  # buckets are keyed by padded length
        return self._qid_strs[bucket][idx]

    def __len__(self):
        total = 0
        for b, (feats, *_rest) in self._packed.items():
            total += math.ceil(feats.shape[0] / self.batch_size_for(b))
        return total



# --- label masking (semi-supervised simulation) ------------------------------


def random_mask_all_labels(queries: Sequence[Query], mask_ratio: float,
                           mask_value: float = 0.0, seed: int = 137,
                           presort: bool = True) -> List[Query]:
    """Set the label of a random `mask_ratio` of each query's docs to
    `mask_value` (all of them kept when none relevant would be left), then
    resort; the JAX package's numpy draws."""
    rng = np.random.RandomState(seed)
    out = []
    for qid, f, l in queries:
        n = len(l)
        n_mask = int(n * mask_ratio)
        l2 = l.copy()
        if n_mask > 0:
            inds = rng.choice(n, size=n_mask, replace=False)
            l2[inds] = mask_value
        if (l2 > 0).sum() < 1:  # keep at least one relevant doc
            l2 = l.copy()
        if presort:
            order = np_shuffle_ties_argsort(l2, rng=rng)
            f, l2 = f[order], l2[order]
        out.append((qid, f, l2))
    return out


def random_mask_rele_labels(queries: Sequence[Query], mask_ratio: float,
                            mask_value: float = 0.0, seed: int = 137,
                            presort: bool = True) -> List[Query]:
    """Set a random `mask_ratio` of each query's relevant labels to
    `mask_value` (none when that would leave no relevant doc), then resort;
    the JAX package's numpy draws."""
    rng = np.random.RandomState(seed)
    out = []
    for qid, f, l in queries:
        rele = np.flatnonzero(l > 0)
        n_mask = int(len(rele) * mask_ratio)
        l2 = l.copy()
        if 0 < n_mask < len(rele):
            inds = rng.choice(rele, size=n_mask, replace=False)
            l2[inds] = mask_value
        if presort:
            order = np_shuffle_ties_argsort(l2, rng=rng)
            f, l2 = f[order], l2[order]
        out.append((qid, f, l2))
    return out

def make_synthetic_queries(
    num_queries: int = 64,
    num_features: int = 46,
    max_label: int = 2,
    min_docs: int = 5,
    max_docs: int = 40,
    seed: int = 137,
    presort: bool = True,
    teacher_seed: int = 7,
) -> List[Query]:
    """Learnable synthetic LETOR data: labels follow a linear teacher over the
    features (drawn from `teacher_seed`, shared across splits), list lengths
    vary, label marginals skew to 0."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(teacher_seed).randn(num_features) / math.sqrt(num_features)
    out: List[Query] = []
    for qi in range(num_queries):
        n = int(rng.randint(min_docs, max_docs + 1))
        f = rng.randn(n, num_features).astype(np.float32)
        logits = f @ w + 0.35 * rng.randn(n)
        # map logit quantiles to graded labels with a zero-heavy marginal
        qcuts = np.quantile(logits, [0.55, 0.8, 0.92, 0.98][:max_label])
        l = np.zeros(n, np.float32)
        for g in range(1, max_label + 1):
            l[logits >= qcuts[g - 1]] = g
        if (l > 0).sum() == 0:
            l[np.argmax(logits)] = 1.0
        if presort:
            order = np_shuffle_ties_argsort(l, rng=rng)
            f, l = f[order], l[order]
        out.append((f"syn{qi}", f, l))
    return out
