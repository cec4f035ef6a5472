"""LightGBMLambdaMART: GBDT ranking through LightGBM (an optional import).

Counterpart of ptranking_tpu/tree/lambdamart.py. LightGBM is an external
package; its import is guarded so the rest of the port works without it (the
tree evaluator then falls back to the native GBDT, tree/gbdt.py). The flat
(data, target, group) helpers and the libsvm files serve any GBM backend.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ptranking_tpu_torch.data.letor import Query
from ptranking_tpu_torch.tree.objectives import CUSTOM_OBJECTIVES

try:  # pragma: no cover - environment dependent
    import lightgbm as lgbm

    HAS_LIGHTGBM = True
except ImportError:  # pragma: no cover
    lgbm = None
    HAS_LIGHTGBM = False

# the reference's LightGBM defaults
DEFAULT_LIGHTGBM_PARAS = {
    "boosting_type": "gbdt",
    "objective": "lambdarank",
    "metric": "ndcg",
    "learning_rate": 0.05,
    "num_leaves": 400,
    "num_trees": 1000,
    "num_threads": 16,
    "min_data_in_leaf": 50,
    "min_sum_hessian_in_leaf": 200,
    "verbosity": -1,
}


def queries_to_flat(queries: Sequence[Query]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-query tuples -> flat (data, target, group) arrays."""
    if not queries:
        return np.zeros((0, 1)), np.zeros(0), np.zeros(0, int)
    data = np.concatenate([q[1] for q in queries], axis=0)
    target = np.concatenate([q[2] for q in queries], axis=0)
    group = np.asarray([len(q[2]) for q in queries], dtype=np.int64)
    return data, target, group


def save_libsvm(path: str, data: np.ndarray, target: np.ndarray, group: np.ndarray,
                zero_based: bool = False):
    """Flat arrays -> a libsvm file with a companion .group file; zero-valued
    features are omitted."""
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for row, y in zip(data, target):
            nz = np.flatnonzero(row)
            feats = " ".join(f"{j + off}:{row[j]:g}" for j in nz)
            f.write(f"{int(y)} {feats}\n")
    np.savetxt(path + ".group", group, fmt="%d")


def load_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of save_libsvm (keeps the tree path sklearn-free)."""
    labels, rows = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            labels.append(float(toks[0]))
            rows.append({int(t.split(":")[0]) - 1: float(t.split(":")[1]) for t in toks[1:]})
    width = max((max(r) + 1 for r in rows if r), default=1)
    mat = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        for j, v in r.items():
            mat[i, j] = v
    group = np.loadtxt(path + ".group").astype(np.int64).reshape(-1)
    return mat, np.asarray(labels, np.float32), group


class LightGBMLambdaMART:
    """LambdaMART through LightGBM, with the reference's defaults and its
    custom objectives (tree/objectives.py) as fobj."""

    def __init__(self, para_dict: Optional[Dict] = None):
        para_dict = para_dict or {}
        self.id = "LightGBMLambdaMART"
        self.custom_dict = para_dict.get("custom_dict", {"custom": False, "custom_obj_id": None,
                                                         "use_LGBMRanker": False})
        self.lightgbm_para_dict = {**DEFAULT_LIGHTGBM_PARAS,
                                   **para_dict.get("lightgbm_para_dict", {})}
        self.booster = None

    def fit(self, train: Tuple[np.ndarray, np.ndarray, np.ndarray],
            vali: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
            early_stopping_rounds: int = 200):
        if not HAS_LIGHTGBM:
            raise ImportError(
                "lightgbm is not installed; the GBDT branch delegates boosting to "
                "LightGBM just like the reference (install lightgbm to enable)")
        x, y, g = train
        train_set = lgbm.Dataset(data=x, label=y, group=g)
        valid_sets = None
        if vali is not None:
            xv, yv, gv = vali
            valid_sets = [lgbm.Dataset(data=xv, label=yv, group=gv, reference=train_set)]
        params = dict(self.lightgbm_para_dict)
        fobj = None
        if self.custom_dict.get("custom"):
            fobj = CUSTOM_OBJECTIVES[self.custom_dict["custom_obj_id"]][1]
            params["objective"] = fobj
        callbacks = []
        if valid_sets is not None:
            callbacks.append(lgbm.early_stopping(early_stopping_rounds, verbose=False))
        self.booster = lgbm.train(params=params, train_set=train_set,
                                  valid_sets=valid_sets, callbacks=callbacks)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.booster is None:
            raise RuntimeError("call fit() first")
        return self.booster.predict(x)

    def save_model(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.booster.save_model(path)

    def load_model(self, path: str):
        if not HAS_LIGHTGBM:
            raise ImportError("lightgbm is not installed")
        self.booster = lgbm.Booster(model_file=path)
        return self
