"""Adversarial-branch parameter system: JSON/grid/para-string config.

The port's copy of ptranking_tpu/adversarial/settings.py (reference
ad_parameter.py, ltr_adversarial/eval/ad_parameter.py:16-253):
AdScoringFunctionParameter (:16-38, pointsf-only with Adam lr 1e-3 and
AF='R'), AdEvalSetting (:41-145, epochs 50, vali nDCG@5), AdDataSetting
(:148-253, train_rough_batch_size=1 in the reference; batched padded
buckets here), plus the per-model <IRGAN/IRFGAN>Parameter classes: defaults,
grid_search iterators (incl. the 'd_g_epoch' "d-g" string axes) and
to_para_string run-dir identifiers, over the port's eval/settings.py.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, Iterator

from ptranking_tpu_torch.eval.settings import (
    DataSetting,
    EvalSetting,
    SFSetting,
    _as_list,
    _first,
)
from ptranking_tpu_torch.models import ScorerConfig
from ptranking_tpu_torch.train.optimizer import OptimizerConfig

# Default hyper-parameters per machine (reference IRGAN_PointParameter etc.).
AD_DEFAULT_PARAS: Dict[str, dict] = {
    # reference irgan_point.py IRGAN_PointParameter: d/g epochs 1, temp 0.5,
    # DG order, 5 samples
    "IRGAN_Point": {"d_epoches": 1, "g_epoches": 1, "temperature": 0.5,
                    "ad_training_order": "DG", "samples_per_query": 5},
    "IRGAN_Pair": {"d_epoches": 1, "g_epoches": 1, "temperature": 0.5,
                   "ad_training_order": "DG", "samples_per_query": 5, "loss_type": "svm",
                   "truth_sampling": "uniform"},
    "IRGAN_List": {"d_epoches": 1, "g_epoches": 1, "temperature": 0.5,
                   "ad_training_order": "DG", "samples_per_query": 5, "top_k": 5,
                   "PL_D": True, "repTrick_D": True, "repTrick_G": False, "dropLog": False},
    "IRFGAN_Point": {"f_div_id": "KL", "d_epoches": 1, "g_epoches": 1,
                     "ad_training_order": "DG", "samples_per_query": 5},
    "IRFGAN_Pair": {"f_div_id": "KL", "d_epoches": 1, "g_epoches": 1,
                    "ad_training_order": "DG", "samples_per_query": 5},
    "IRFGAN_List": {"f_div_id": "KL", "d_epoches": 1, "g_epoches": 1,
                    "ad_training_order": "DG", "samples_per_query": 5, "top_k": 5},
}

# Non-debug grid axes (reference <Model>Parameter.grid_search else-branches).
AD_MODEL_GRIDS: Dict[str, Dict[str, list]] = {
    "IRGAN_Point": {"d_g_epoch": ["1-1"], "temperature": [0.5],
                    "samples_per_query": [5], "ad_training_order": ["DG"]},
    "IRGAN_Pair": {"d_g_epoch": ["1-1"], "temperature": [0.5],
                   "samples_per_query": [5], "ad_training_order": ["DG"],
                   "loss_type": ["svm"]},
    "IRGAN_List": {"d_g_epoch": ["1-1"], "temperature": [0.5],
                   "samples_per_query": [5], "ad_training_order": ["DG"],
                   "top_k": [5], "PL_D": [True], "repTrick_G": [False],
                   "dropLog": [True]},
    "IRFGAN_Point": {"d_g_epoch": ["1-1"], "f_div_id": ["KL"],
                     "samples_per_query": [5], "ad_training_order": ["DG"]},
    "IRFGAN_Pair": {"d_g_epoch": ["1-1"], "f_div_id": ["KL"],
                    "samples_per_query": [5], "ad_training_order": ["DG"]},
    "IRFGAN_List": {"d_g_epoch": ["1-1"], "f_div_id": ["KL"],
                    "samples_per_query": [5], "ad_training_order": ["DG"],
                    "top_k": [5]},
}


class AdDataSetting(DataSetting):
    """Reference AdDataSetting (ad_parameter.py:148-253). The reference pins
    train_rough_batch_size=1 (its machines loop queries in Python); the
    machines here run batched padded buckets, so tr_batch_size is a free
    (docs-per-batch) axis defaulting to 512."""

    JSON_SECTION = "AdDataSetting"

    def __init__(self, debug=False, data_id=None, dir_data=None, data_json=None):
        self.debug = debug
        self.use_json = data_json is not None
        if self.use_json:
            with open(data_json) as f:
                self.json_dict = json.load(f)[self.JSON_SECTION]
            self.data_id = self.json_dict["data_id"]
            self.dir_data = self.json_dict["dir_data"]
        else:
            self.json_dict = {}
            self.data_id = data_id
            self.dir_data = dir_data
        self.data_dict: Dict[str, Any] = {}

    def default_setting(self) -> Dict[str, Any]:
        d = self._base()
        j = self.json_dict
        d.update(
            min_docs=_first(j.get("min_docs", 10)),
            min_rele=_first(j.get("min_rele", 1)),
            binary_rele=_first(j.get("binary_rele", False)),
            unknown_as_zero=_first(j.get("unknown_as_zero", False)),
            tr_batch_size=_first(j.get("tr_batch_size", 512)),
            validation_rough_batch_size=_first(j.get("validation_rough_batch_size", 100)),
            test_rough_batch_size=_first(j.get("test_rough_batch_size", 100)),
        )
        self.data_dict = d
        return d


class AdEvalSetting(EvalSetting):
    """Reference AdEvalSetting (ad_parameter.py:41-145): epochs 10 debug / 50,
    vali nDCG@5."""

    JSON_SECTION = "AdEvalSetting"

    def __init__(self, debug=False, dir_output=None, eval_json=None,
                 overrides=None):
        self.debug = debug
        self.use_json = eval_json is not None
        if self.use_json:
            with open(eval_json) as f:
                self.json_dict = json.load(f)[self.JSON_SECTION]
            self.dir_output = self.json_dict["dir_output"]
        else:
            self.json_dict = {}
            self.dir_output = dir_output
        self.overrides = dict(overrides or {})  # CLI > JSON > defaults
        self.eval_dict: Dict[str, Any] = {}

    def default_setting(self) -> Dict[str, Any]:
        d = super().default_setting()
        if "epochs" not in self.json_dict:
            d["epochs"] = 10 if self.debug else 50  # ad_parameter.py:80
        d.setdefault("vali_metric", "nDCG")
        self.eval_dict = d
        return d

    def to_eval_setting_string(self, log=False) -> str:
        # reference ad format: EP_{epochs}_V_{do_validation} (ad_parameter.py:53-67)
        d = self.eval_dict
        s1 = ":" if log else "_"
        return s1.join(["EP", str(d["epochs"]), "V", str(d["do_validation"])])


class AdSFSetting(SFSetting):
    """Reference AdScoringFunctionParameter (ad_parameter.py:16-38): pointsf
    only (listsf unsupported due to the sampling mechanism), Adam lr 1e-3,
    AF='R', TL_AF='R', BN off."""

    def __init__(self, debug=False, sf_id="pointsf", sf_json=None):
        super().__init__(debug=debug, sf_id=sf_id, sf_json=sf_json)
        if not self.sf_id.startswith("pointsf"):
            raise ValueError("adversarial ltr supports pointsf only (ad_parameter.py:36-38)")

    def default_setting(self, num_features: int):
        j = self.json_dict
        sub = j.get("pointsf", {})
        cfg = ScorerConfig(
            sf_id="pointsf", num_features=num_features,
            num_layers=_first(sub.get("layers", 5)),
            AF=_first(sub.get("AF", "R")),
            TL_AF=_first(sub.get("TL_AF", sub.get("tl_af", "R"))),
            apply_tl_af=_first(sub.get("apply_tl_af", True)),
            BN=_first(sub.get("BN", False)),
            bn_type=_first(sub.get("bn_type", "BN")),
            bn_affine=_first(sub.get("bn_affine", True)),
        )
        opt = OptimizerConfig(opt=_first(j.get("opt", "Adam")), lr=_first(j.get("lr", 1e-3)))
        self.sf_para = {"scorer": cfg, "optimizer": opt}
        return self.sf_para


class AdModelSetting:
    """Per-machine hyper-parameter defaults/grids/para-strings (reference
    IRGAN_PointParameter etc.)."""

    def __init__(self, model_id: str, debug=False, para_json=None):
        if model_id not in AD_DEFAULT_PARAS:
            raise KeyError(model_id)
        self.model_id = model_id
        self.debug = debug
        self.use_json = para_json is not None and os.path.exists(para_json or "")
        if self.use_json:
            with open(para_json) as f:
                loaded = json.load(f)
            # reference per-model jsons are flat axis dicts; also accept a
            # {model_id: {...}} wrapper matching our adhoc convention
            self.json_dict = loaded.get(model_id, loaded)
        else:
            self.json_dict = {}
        self.para_dict: Dict[str, Any] = {}

    @staticmethod
    def _expand_d_g(axes: Dict[str, list]) -> Dict[str, list]:
        """The reference encodes (d_epoches, g_epoches) as 'd-g' strings under
        the single axis 'd_g_epoch' (irgan_point.py grid_search)."""
        if "d_g_epoch" not in axes:
            return axes
        axes = dict(axes)
        pairs = [tuple(int(x) for x in str(s).split("-")) for s in axes.pop("d_g_epoch")]
        axes["_d_g"] = pairs
        return axes

    def default_para_dict(self) -> Dict[str, Any]:
        d = dict(AD_DEFAULT_PARAS[self.model_id])
        for k, v in self.json_dict.items():
            if k == "d_g_epoch":
                dd, gg = str(_first(v)).split("-")
                d["d_epoches"], d["g_epoches"] = int(dd), int(gg)
            else:
                d[k] = _first(v)
        self.para_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        axes = {k: _as_list(v) for k, v in AD_MODEL_GRIDS[self.model_id].items()}
        for k, v in self.json_dict.items():
            axes[k] = _as_list(v)
        axes = self._expand_d_g(axes)
        keys = list(axes)
        for combo in itertools.product(*(axes[k] for k in keys)):
            d = dict(AD_DEFAULT_PARAS[self.model_id])
            c = dict(zip(keys, combo))
            if "_d_g" in c:
                d["d_epoches"], d["g_epoches"] = c.pop("_d_g")
            d.update(c)
            self.para_dict = d
            yield d

    def to_para_string(self, log=False) -> str:
        """Reference per-model string formats (irgan_point.py/irgan_pair.py/
        irgan_list.py to_para_string)."""
        d = self.para_dict or self.default_para_dict()
        s1 = ":" if log else "_"
        base = [str(d["d_epoches"]), str(d["g_epoches"]),
                f"{d['temperature']:g}" if "temperature" in d else None,
                d["ad_training_order"]]
        base = [x for x in base if x is not None]
        mid = self.model_id
        if mid == "IRGAN_Point":
            return s1.join(base + [str(d["samples_per_query"])])
        if mid == "IRGAN_Pair":
            return s1.join(base + [d["loss_type"], str(d["samples_per_query"])])
        if mid == "IRGAN_List":
            top_k_str = "topAll" if d.get("top_k") is None else f"top{d['top_k']}"
            s = s1.join(base + [top_k_str, f"S{d['samples_per_query']}",
                                "PLD" if d.get("PL_D", True) else "BTD"])
            if d.get("repTrick_G") or d.get("repTrick"):
                s += "_Rep"
            if d.get("dropLog"):
                s += "_DropLog"
            return s
        # IRFGAN_*: prefix with the f-divergence id
        parts = [d["f_div_id"]] + base + [f"S{d['samples_per_query']}"]
        if mid == "IRFGAN_List" and d.get("top_k") is not None:
            parts.append(f"top{d['top_k']}")
        return s1.join(parts)
