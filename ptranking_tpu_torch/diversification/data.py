"""Diversity data: TREC Web Track 09-12 loading and padded bucket batching.

The port's copy of ptranking_tpu/diversification/data.py, all numpy, so one
seed gives the JAX package's arrays. Each query is (qid, q_repr [D],
doc_reprs [N, D], rele_mat [S, N]) with the docs presorted into the greedy
ideal diversified order; batches are padded on both the doc axis and the
subtopic axis to fixed bucket shapes. `rerank_queries` keeps a trained
first-stage ranker's top-k docs of each query.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ptranking_tpu_torch.data.dataset import pick_buckets
from ptranking_tpu_torch.metrics.srd import np_greedy_ideal_ranking

TREC_DIV = ["WT_Div_0912_Implicit", "WT_Div_0912_Explicit"]
DIV_SYNTHETIC = ["SyntheticDiv"]


def get_div_data_meta(data_id: str):
    """(reference get_div_data_meta, div_data.py:17-27)."""
    if data_id in TREC_DIV or data_id in DIV_SYNTHETIC:
        return dict(num_features=100, fold_num=5, max_label=1)
    raise NotImplementedError(data_id)


class DivQuery(NamedTuple):
    qid: str
    q_repr: np.ndarray      # [D]
    doc_reprs: np.ndarray   # [N, D]
    rele_mat: np.ndarray    # [S, N] 0/1 subtopic coverage
    # real docnos, same order as doc_reprs rows (reference keeps perm_docs
    # end-to-end, div_data.py:53-127, so run files carry official TREC ids);
    # None only for legacy callers
    docnos: Optional[Tuple[str, ...]] = None


class DivBatch(NamedTuple):
    q_repr: np.ndarray      # [B, D]
    doc_reprs: np.ndarray   # [B, N, D]
    rele_mat: np.ndarray    # [B, S, N]
    doc_mask: np.ndarray    # [B, N]
    subtopic_mask: np.ndarray  # [B, S]
    qids: Optional[np.ndarray] = None


def to_matrix(perm_docs: Sequence[str], q_doc_subtopics: dict) -> np.ndarray:
    """docid list + {docid: [subtopic ids]} -> [S, N] 0/1 matrix (reference
    to_matrix, div_data.py:29-49)."""
    num_docs = len(perm_docs)
    rele = np.zeros((20, num_docs), np.float32)
    max_sub = 0
    for col, doc in enumerate(perm_docs):
        for sub in q_doc_subtopics.get(doc, []):
            sid = int(sub)
            rele[sid - 1, col] = 1.0
            max_sub = max(max_sub, sid)
    return rele[:max_sub] if max_sub else rele[:1]


def load_trec_div_fold(
    dir_data: str,
    fold_qids: Sequence,
    presort: bool = True,
    alpha: float = 0.5,
    add_noise: bool = False,
    std_delta: float = 1.0,
    seed: int = 137,
) -> List[DivQuery]:
    """Load TREC WT queries from the raw json/dat layout (reference
    DIVDataset.__init__, div_data.py:53-127 + load_raw_data in
    ltr_diversification.py:155-206):
      query_representation.dat / doc_representation.dat (json dicts),
      query_permutation.json, query_doc.json.
    """
    with open(os.path.join(dir_data, "query_representation.dat")) as f:
        q_reprs = json.load(f)
    with open(os.path.join(dir_data, "doc_representation.dat")) as f:
        d_reprs = json.load(f)
    with open(os.path.join(dir_data, "query_permutation.json")) as f:
        q_perms = json.load(f)
    with open(os.path.join(dir_data, "query_doc.json")) as f:
        q_doc_subs = json.load(f)

    rng = np.random.RandomState(seed)
    out: List[DivQuery] = []
    for qid in fold_qids:
        qid = str(qid)
        q_repr = np.asarray(q_reprs[qid], np.float32).reshape(-1)
        perm_docs = list(q_perms[qid]["permutation"])
        subs = q_doc_subs[qid]
        if presort:
            rele0 = to_matrix(perm_docs, subs)
            order = np_greedy_ideal_ranking(rele0, alpha)
            perm_docs = [perm_docs[i] for i in order]
        doc_reprs = np.vstack([np.asarray(d_reprs[d], np.float32).reshape(1, -1)
                               for d in perm_docs])
        if add_noise:
            q_repr = q_repr + rng.normal(0, std_delta, q_repr.shape).astype(np.float32)
            doc_reprs = doc_reprs + rng.normal(0, std_delta, doc_reprs.shape).astype(np.float32)
        rele_mat = to_matrix(perm_docs, subs)
        out.append(DivQuery(qid, q_repr, doc_reprs, rele_mat, tuple(perm_docs)))
    return out


def make_synthetic_div_queries(
    num_queries: int = 40,
    num_features: int = 100,
    max_subtopics: int = 8,
    min_docs: int = 10,
    max_docs: int = 50,
    seed: int = 137,
    presort: bool = True,
    teacher_seed: int = 11,
) -> List[DivQuery]:
    """Learnable synthetic diversity data: subtopics live in feature subspaces;
    a doc covers a subtopic when its projection onto that subtopic's direction
    (conditioned on the query) is large."""
    rng = np.random.RandomState(seed)
    t_rng = np.random.RandomState(teacher_seed)
    sub_dirs = t_rng.randn(max_subtopics, num_features) / math.sqrt(num_features)
    out: List[DivQuery] = []
    for qi in range(num_queries):
        S = int(rng.randint(2, max_subtopics + 1))
        N = int(rng.randint(min_docs, max_docs + 1))
        q = rng.randn(num_features).astype(np.float32)
        docs = rng.randn(N, num_features).astype(np.float32)
        proj = (docs + 0.2 * q[None]) @ sub_dirs[:S].T  # [N, S]
        thresh = np.quantile(proj, 0.8, axis=0)
        rele = (proj > thresh[None]).T.astype(np.float32)  # [S, N]
        if rele.sum() == 0:
            rele[0, int(np.argmax(proj[:, 0]))] = 1.0
        docnos = np.asarray([f"synth{qi}-{j:04d}" for j in range(N)])
        if presort:
            order = np_greedy_ideal_ranking(rele)
            docs, rele, docnos = docs[order], rele[:, order], docnos[order]
        out.append(DivQuery(f"divq{qi}", q, docs, rele, tuple(docnos)))
    return out


class DivBucketedDataset:
    """Pads diversity queries to fixed (doc, subtopic) bucket shapes."""

    def __init__(self, queries: Sequence[DivQuery], batch_queries: int = 8,
                 doc_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 seed: int = 137):
        self.seed = seed
        self.batch_queries = batch_queries
        sizes = [q.doc_reprs.shape[0] for q in queries]
        self.doc_buckets = pick_buckets(sizes, doc_buckets)
        self.max_subtopics = max((q.rele_mat.shape[0] for q in queries), default=1)
        self.num_features = queries[0].q_repr.shape[0] if queries else 0
        self._by_bucket = {b: [] for b in self.doc_buckets}
        for q in queries:
            b = next(x for x in self.doc_buckets if x >= q.doc_reprs.shape[0])
            self._by_bucket[b].append(q)
        self.num_queries = len(queries)
        # pack each bucket into contiguous padded arrays ONCE (the per-epoch
        # Python padding loop used to rebuild every batch from scratch)
        S, D = self.max_subtopics, self.num_features
        self._packed = {}
        for b, items in self._by_bucket.items():
            if not items:
                continue
            Q = len(items)
            q_repr = np.zeros((Q, D), np.float32)
            doc_reprs = np.zeros((Q, b, D), np.float32)
            rele = np.zeros((Q, S, b), np.float32)
            dmask = np.zeros((Q, b), bool)
            smask = np.zeros((Q, S), bool)
            for i, q in enumerate(items):
                n, s = q.doc_reprs.shape[0], q.rele_mat.shape[0]
                q_repr[i] = q.q_repr
                doc_reprs[i, :n] = q.doc_reprs
                rele[i, :s, :n] = q.rele_mat
                dmask[i, :n] = True
                smask[i, :s] = True
            self._packed[b] = (q_repr, doc_reprs, rele, dmask, smask)

    def batches(self, shuffle: bool = False, epoch: int = 0) -> Iterator[DivBatch]:
        rng = np.random.RandomState(self.seed + epoch)
        for b in self._packed:
            q_repr, doc_reprs, rele, dmask, smask = self._packed[b]
            Q = q_repr.shape[0]
            idx = rng.permutation(Q) if shuffle else np.arange(Q)
            B = self.batch_queries
            for lo in range(0, Q, B):
                sl = idx[lo:lo + B]
                nb = len(sl)
                if nb == B:
                    yield DivBatch(q_repr[sl], doc_reprs[sl], rele[sl],
                                   dmask[sl], smask[sl], sl.astype(np.int32))
                    continue
                # padded remainder batch (all-masked tail rows, qid -1)
                pad = lambda a: np.concatenate(
                    [a[sl], np.zeros((B - nb, *a.shape[1:]), a.dtype)], axis=0)
                qids = np.full((B,), -1, np.int32)
                qids[:nb] = sl
                yield DivBatch(pad(q_repr), pad(doc_reprs), pad(rele),
                               pad(dmask), pad(smask), qids)

    def query_for(self, batch: DivBatch, row: int) -> Optional[DivQuery]:
        """Public accessor: the DivQuery behind `batch` row `row`, or None for
        an all-padded remainder row. DivBatch.qids carries the per-bucket item
        index; the bucket is keyed by the padded doc-axis length."""
        idx = int(np.asarray(batch.qids)[row])
        if idx < 0:
            return None
        bucket = batch.doc_reprs.shape[1]
        return self._by_bucket[bucket][idx]

    def __len__(self):
        return sum(math.ceil(len(v) / self.batch_queries) for v in self._by_bucket.values() if v)


def rerank_queries(queries, ranker, top_k: int):
    """Two-stage rerank: a trained discriminator scores each query's docs and
    only its top-k survive into the second-stage dataset (reference
    RerankDIVDataset + deploy_1st_stage_div_discriminating,
    div_data.py:130-192). Docs are kept in first-stage score order; queries
    with <= top_k docs pass through unchanged."""
    out = []
    ds = DivBucketedDataset(queries, batch_queries=1)
    ordered = [q for b in ds.doc_buckets for q in ds._by_bucket[b]]
    for q, batch in zip(ordered, ds.batches()):
        n = q.doc_reprs.shape[0]
        if n <= top_k:
            out.append(q)
            continue
        scores = ranker.predict(batch)[0, :n].cpu().numpy()
        keep = np.argsort(-scores, kind="stable")[:top_k]
        kept_docnos = (tuple(np.asarray(q.docnos)[keep]) if q.docnos is not None
                       else None)
        out.append(DivQuery(q.qid, q.q_repr, q.doc_reprs[keep],
                            q.rele_mat[:, keep], kept_docnos))
    return out
