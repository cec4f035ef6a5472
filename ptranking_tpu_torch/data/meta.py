"""Dataset registry, per-dataset metadata and the scaler policy.

The port's own copy of ptranking_tpu/data/meta.py (numpy only), as far as
the LETOR loader needs it: `get_data_meta`, `get_scaler_setting` and
`scale_features`, with sklearn-compatible scaler semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ptranking_tpu_torch.types import LabelType

MSLETOR_SEMI = ["MQ2007_Semi", "MQ2008_Semi"]
MSLETOR_LIST = ["MQ2007_List", "MQ2008_List"]
MSLETOR_SUPER = ["MQ2007_Super", "MQ2008_Super"]
MSLETOR = MSLETOR_SUPER + MSLETOR_SEMI + MSLETOR_LIST
IRGAN_MQ2008_SEMI = ["IRGAN_MQ2008_Semi"]
MSLRWEB = ["MSLRWEB10K", "MSLRWEB30K"]
YAHOO_LTR = ["Set1", "Set2"]
YAHOO_LTR_5Fold = ["5FoldSet1", "5FoldSet2"]
ISTELLA_LTR = ["Istella_S", "Istella", "Istella_X"]
ISTELLA_MAX = 1_000_000  # clamp for Istella's 1.79e308 features
GLTR_LIBSVM = ["LTR_LibSVM", "LTR_LibSVM_K"]
GLTR_LETOR = ["LETOR", "LETOR_K"]
SYNTHETIC = ["SyntheticMQ", "SyntheticWEB30K"]

SCALER_ID = ["MinMaxScaler", "RobustScaler", "StandardScaler", "SLog1P"]


@dataclasses.dataclass(frozen=True)
class DataMeta:
    num_features: int
    has_comment: bool
    label_type: LabelType
    max_rele_level: Optional[int]
    fold_num: int


def get_data_meta(data_id: str, json_dict: Optional[dict] = None) -> DataMeta:
    """Per-dataset metadata. Generic LETOR/LibSVM ids declare their shape in
    `json_dict` (`num_features` required; `max_rele_level`, `has_comment` and
    `fold_num` optional)."""
    if data_id in GLTR_LIBSVM or data_id in GLTR_LETOR:
        j = json_dict or {}
        if "num_features" not in j:
            raise ValueError(
                f"{data_id}: generic LTR datasets must declare num_features "
                "in the DataSetting section (plus optional max_rele_level, "
                "has_comment, fold_num)")
        nf = j["num_features"]
        num_features = int(nf[0] if isinstance(nf, list) else nf)
        _one = lambda v, d: (v[0] if isinstance(v, list) else v) if v is not None else d
        return DataMeta(
            num_features,
            bool(_one(j.get("has_comment"), False)),
            LabelType.MultiLabel,
            int(_one(j.get("max_rele_level"), 4)),
            int(_one(j.get("fold_num"), 5 if data_id.endswith("_K") else 1)),
        )
    if data_id in MSLRWEB:
        return DataMeta(136, False, LabelType.MultiLabel, 4, 5)
    if data_id in MSLETOR_SUPER or data_id in MSLETOR_SEMI or data_id in IRGAN_MQ2008_SEMI:
        return DataMeta(46, True, LabelType.MultiLabel, 2, 5)
    if data_id in MSLETOR_LIST:
        return DataMeta(46, True, LabelType.Permutation, None, 5)
    if data_id in YAHOO_LTR:
        return DataMeta(700, False, LabelType.MultiLabel, 4, 1)
    if data_id in YAHOO_LTR_5Fold:
        return DataMeta(700, False, LabelType.MultiLabel, 4, 5)
    if data_id in ISTELLA_LTR:
        return DataMeta(220, data_id == "Istella_X", LabelType.MultiLabel, 4, 1)
    if data_id == "SyntheticMQ":
        return DataMeta(46, False, LabelType.MultiLabel, 2, 5)
    if data_id == "SyntheticWEB30K":
        return DataMeta(136, False, LabelType.MultiLabel, 4, 5)
    raise NotImplementedError(data_id)


def get_scaler_setting(data_id: str, scaler_id: Optional[str] = None):
    """Default scaling policy: query-level StandardScaler for MSLR/Istella,
    nothing for LETOR/Yahoo (already normalised)."""
    if scaler_id is None:
        if data_id in MSLRWEB or data_id in ISTELLA_LTR or data_id == "SyntheticWEB30K":
            return True, "StandardScaler", "QUERY"
        return False, None, None
    if scaler_id not in SCALER_ID:
        raise NotImplementedError(scaler_id)
    return True, scaler_id, "QUERY"


def _handle_zeros(scale: np.ndarray) -> np.ndarray:
    return np.where(scale == 0.0, 1.0, scale)


def scale_features(x: np.ndarray, scaler_id: str) -> np.ndarray:
    """Column-wise scaling of one query's [n_docs, F] feature matrix."""
    if scaler_id == "MinMaxScaler":
        mn, mx = x.min(axis=0), x.max(axis=0)
        return (x - mn) / _handle_zeros(mx - mn)
    if scaler_id == "RobustScaler":
        med = np.median(x, axis=0)
        q75, q25 = np.percentile(x, 75, axis=0), np.percentile(x, 25, axis=0)
        return (x - med) / _handle_zeros(q75 - q25)
    if scaler_id == "StandardScaler":
        return (x - x.mean(axis=0)) / _handle_zeros(x.std(axis=0))
    if scaler_id == "SLog1P":
        return np.sign(x) * np.log1p(np.abs(x))
    raise NotImplementedError(scaler_id)
