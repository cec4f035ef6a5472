"""LETOR/LibSVM text parsing and per-query assembly (numpy).

The port's own copy of ptranking_tpu/data/letor.py. `load_letor_file`
parses through the ctypes wrapper of native/letor_parser.cpp
(data/native_parser.py) and falls back to the pure-Python
`parse_letor_lines`, the oracle, where no C++ compiler exists. Queries come
out as (qid, [n, F] features, [n] labels) in first-appearance
order, and a parsed file is cached beside it as a packed `.npz` keyed by the
load settings (the same file name and format as the JAX package's cache).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ptranking_tpu_torch.data.meta import (
    ISTELLA_LTR,
    ISTELLA_MAX,
    MSLETOR_LIST,
    YAHOO_LTR,
    get_data_meta,
    get_scaler_setting,
    scale_features,
)
from ptranking_tpu_torch.data.native_parser import parse_letor_file_native

Query = Tuple[str, np.ndarray, np.ndarray]  # (qid, [n, F] features, [n] labels)


def np_shuffle_ties_argsort(labels: np.ndarray, descending: bool = True,
                            rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Descending argsort with uniformly shuffled ties."""
    rng = rng or np.random
    perm = rng.permutation(len(labels))
    shuffled = labels[perm]
    order = np.argsort(-shuffled if descending else shuffled, kind="stable")
    return perm[order]


def parse_letor_lines(lines, has_targets=True, one_indexed=True, missing=0.0,
                      has_comment=False):
    """Parse LETOR rows -> (features [R, F], labels [R], qids list[, docids]).

    The feature width grows to the largest id seen; ids are 1- or 0-indexed;
    with `has_comment`, '#docid = X' comments give the docids.
    """
    feats: List[Dict[int, float]] = []
    labels: List[float] = []
    qids: List[str] = []
    docids: List[str] = []
    max_fid = 0
    for line in lines:
        if has_comment:
            data, _, comment = line.rstrip().partition("#")
            toks = data.split()
        else:
            toks = line.rstrip().split()
            comment = ""
        if not toks:
            continue
        if has_targets:
            labels.append(float(toks[0]))
            toks = toks[1:]
        else:
            labels.append(-1.0)
        qid_tok = toks[0]
        if not qid_tok.startswith("qid:"):
            raise ValueError(f"expected 'qid:<id>', got {qid_tok!r}")
        qids.append(qid_tok[4:])
        row: Dict[int, float] = {}
        for tok in toks[1:]:
            fid_s, _, val_s = tok.partition(":")
            fid = int(fid_s) - (1 if one_indexed else 0)
            if fid < 0:
                raise ValueError(f"feature id {fid_s} below the first id")
            row[fid] = float(val_s)
            max_fid = max(max_fid, fid + 1)
        feats.append(row)
        if has_comment:
            # 'docid = X' -> X (the comment's third token); shorter comments
            # fall back to the first token
            ctoks = comment.split()
            docids.append(ctoks[2] if len(ctoks) >= 3 else (ctoks[0] if ctoks else ""))

    mat = np.full((len(feats), max_fid), missing, dtype=np.float32)
    for i, row in enumerate(feats):
        for fid, val in row.items():
            mat[i, fid] = val
    lab = np.asarray(labels, dtype=np.float32)
    if has_comment:
        return mat, lab, qids, docids
    return mat, lab, qids


def group_and_clip(
    mat: np.ndarray,
    labels: np.ndarray,
    qids: Sequence[str],
    data_id: str = "LETOR",
    min_docs: Optional[int] = None,
    min_rele: Optional[int] = 1,
    binary_rele: bool = False,
    unknown_as_zero: bool = False,
    presort: bool = True,
    scale_data: Optional[bool] = None,
    scaler_id: Optional[str] = None,
    seed: int = 137,
) -> List[Query]:
    """Rows -> per-query (qid, features, labels), with query-level scaling,
    clipping, label transforms and presort with shuffled ties, keeping the
    first-appearance query order."""
    if scale_data is None:
        scale_data, scaler_id, _ = get_scaler_setting(data_id)
    rng = np.random.RandomState(seed)
    clip = (min_rele or 0) > 0 or (min_docs or 0) > 0

    order: List[str] = []
    index: Dict[str, List[int]] = {}
    for i, q in enumerate(qids):
        if q not in index:
            index[q] = []
            order.append(q)
        index[q].append(i)

    out: List[Query] = []
    for qid in order:
        rows = index[qid]
        f = mat[rows]
        l = labels[rows].copy()
        if data_id in MSLETOR_LIST:
            l = len(l) - l  # rank positions -> grade labels
        if scale_data:
            if data_id in ISTELLA_LTR:
                f = np.clip(f, a_min=None, a_max=ISTELLA_MAX)
            f = scale_features(f, scaler_id)
        if binary_rele:
            l = np.clip(l, -10, 1)
        if unknown_as_zero:
            l = np.clip(l, 0, 10)
        if clip:
            if min_docs and f.shape[0] < min_docs:
                continue
            if (l > 0).sum() < (min_rele or 0):
                continue
        if presort:
            inds = np_shuffle_ties_argsort(l, descending=True, rng=rng)
            f, l = f[inds], l[inds]
        out.append((qid, f.astype(np.float32), l.astype(np.float32)))
    return out


def load_letor_file(
    path: str,
    data_id: str = "LETOR",
    has_comment: Optional[bool] = None,
    **kwargs,
) -> List[Query]:
    """Parse one LETOR/LibSVM file into per-query tuples, through a packed
    .npz cache keyed by (path, settings)."""
    if has_comment is None:
        try:
            has_comment = get_data_meta(data_id).has_comment
        except (NotImplementedError, ValueError):
            has_comment = False  # unknown / generic id without declared meta
    one_indexed = data_id not in YAHOO_LTR

    cache = _cache_path(path, data_id, {**kwargs, "has_comment": has_comment})
    if os.path.exists(cache):
        return _load_packed(cache)
    parsed = parse_letor_file_native(path, one_indexed=one_indexed, has_comment=has_comment)
    if parsed is None:
        with open(path, encoding="iso-8859-1") as f:
            parsed = parse_letor_lines(f, has_comment=has_comment, one_indexed=one_indexed)
    mat, labels, qids = parsed[0], parsed[1], parsed[2]
    queries = group_and_clip(mat, labels, qids, data_id=data_id, **kwargs)
    _save_packed(cache, queries)
    return queries


def write_letor_file(queries: List[Query], path: str,
                     with_comment: bool = True) -> str:
    """Write per-query tuples as LETOR text (`label qid:<q> 1:v 2:v … #docid`),
    the inverse of load_letor_file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for qid, feats, labels in queries:
            for d in range(feats.shape[0]):
                fv = " ".join(f"{i + 1}:{v:.6g}" for i, v in enumerate(feats[d]))
                tail = f" #docid = {qid}-{d}" if with_comment else ""
                f.write(f"{int(labels[d])} qid:{qid} {fv}{tail}\n")
    return path


def _cache_path(path: str, data_id: str, kwargs) -> str:
    key = repr(sorted(kwargs.items()))
    h = hashlib.sha1(f"{data_id}|{key}".encode()).hexdigest()[:12]
    return f"{path}.{h}.npz"


def _save_packed(cache: str, queries: List[Query]):
    if not queries:
        np.savez(cache, qids=np.array([], dtype="U1"),
                 feats=np.zeros((0, 1), np.float32), labels=np.zeros(0, np.float32),
                 offsets=np.zeros(1, np.int64))
        return
    qids = np.array([q[0] for q in queries])
    feats = np.concatenate([q[1] for q in queries], axis=0)
    labels = np.concatenate([q[2] for q in queries], axis=0)
    offsets = np.cumsum([0] + [len(q[2]) for q in queries]).astype(np.int64)
    np.savez(cache, qids=qids, feats=feats, labels=labels, offsets=offsets)


def _load_packed(cache: str) -> List[Query]:
    z = np.load(cache, allow_pickle=False)
    qids, feats, labels, offsets = z["qids"], z["feats"], z["labels"], z["offsets"]
    out = []
    for i in range(len(qids)):
        lo, hi = offsets[i], offsets[i + 1]
        out.append((str(qids[i]), feats[lo:hi], labels[lo:hi]))
    return out
