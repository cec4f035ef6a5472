"""The tree branch's settings: JSON, grids and the para string.

The port's copy of ptranking_tpu/tree/settings.py, on the port's
eval/settings.py helpers: TreeDataSetting (unknown_as_zero for the
semi-supervised data, no presort), TreeEvalSetting
(early_stop_or_boost_round) and TreeModelSetting (LightGBM's defaults, the
BT/metric/leaves/trees/MiData/MSH/LR grid and the BT_..._EvalAt para
string), with the same JSON files and run-directory names.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, Iterator

from ptranking_tpu_torch.data.meta import MSLETOR_SEMI, get_data_meta, get_scaler_setting
from ptranking_tpu_torch.eval.settings import _as_list, _first

TREE_MODEL_IDS = ["LightGBMLambdaMART", "TPUGBDTLambdaMART"]


class TreeDataSetting:
    """The data setting: unknown_as_zero for semi-supervised data
    (LambdaMART is supervised), no presort."""

    JSON_SECTION = "DataSetting"

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
        # the JSON data section lets generic ids resolve their meta
        meta = get_data_meta(self.data_id, json_dict=self.json_dict)
        scale_data, scaler_id, scaler_level = get_scaler_setting(self.data_id)
        j = self.json_dict
        d = dict(
            data_id=self.data_id, dir_data=self.dir_data,
            num_features=meta.num_features, has_comment=meta.has_comment,
            label_type=meta.label_type, max_rele_level=meta.max_rele_level,
            fold_num=2 if self.debug else meta.fold_num,
            min_docs=_first(j.get("min_docs", 10)),
            min_rele=_first(j.get("min_rele", 1)),
            binary_rele=_first(j.get("binary_rele", False)),
            unknown_as_zero=self.data_id in MSLETOR_SEMI,
            train_presort=False, validation_presort=False, test_presort=False,
            scale_data=scale_data, scaler_id=scaler_id, scaler_level=scaler_level,
        )
        self.data_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        j = self.json_dict
        for min_docs, min_rele in itertools.product(
                _as_list(j.get("min_docs", [10])), _as_list(j.get("min_rele", [1]))):
            d = self.default_setting()
            d.update(min_docs=min_docs, min_rele=min_rele)
            self.data_dict = d
            yield d

    def to_data_setting_string(self, log=False) -> str:
        d = self.data_dict
        s1 = ":" if log else "_"
        return s1.join([d["data_id"], "MiD", str(d["min_docs"]),
                        "MiR", str(d["min_rele"])])


class TreeEvalSetting:
    """The eval setting: early_stop_or_boost_round 10 in debug, else 200."""

    JSON_SECTION = "EvalSetting"

    def __init__(self, debug=False, dir_output=None, eval_json=None):
        self.debug = debug
        self.use_json = eval_json is not None
        if self.use_json:
            with open(eval_json) as f:
                self.json_dict = json.load(f)[self.JSON_SECTION]
            self.dir_output = self.json_dict["dir_output"]
        else:
            self.json_dict = {}
            self.dir_output = dir_output
        self.eval_dict: Dict[str, Any] = {}

    def default_setting(self) -> Dict[str, Any]:
        j = self.json_dict
        d = dict(
            debug=self.debug, grid_search=False, dir_output=self.dir_output,
            do_validation=_first(j.get("do_validation", True)),
            do_log=_first(j.get("do_log", not self.debug)),
            cutoffs=j.get("cutoffs", [1, 3, 5, 10, 20, 50]),
            mask_label=_first(j.get("mask", {}).get("mask_label", False)),
            early_stop_or_boost_round=(10 if self.debug else
                                       _first(j.get("early_stop_or_boost_round", 200))),
        )
        self.eval_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        d = self.default_setting()
        d["grid_search"] = True
        if self.debug:
            d["early_stop_or_boost_round"] = 20
        self.eval_dict = d
        yield d

    def to_eval_setting_string(self, log=False) -> str:
        d = self.eval_dict
        s1 = ":" if log else "_"
        key = "EarlyStop" if d["do_validation"] else "BoostRound"
        return s1.join([key, str(d["early_stop_or_boost_round"])])


class TreeModelSetting:
    """The model setting of LightGBMLambdaMART; the same para dict drives the
    native TPUGBDTLambdaMART."""

    def __init__(self, model_id: str = "LightGBMLambdaMART", debug=False, para_json=None):
        if model_id not in TREE_MODEL_IDS:
            raise ValueError(f"{model_id!r} is not a tree model id ({TREE_MODEL_IDS})")
        self.model_id = model_id
        self.debug = debug
        self.use_json = para_json is not None and os.path.exists(para_json or "")
        if self.use_json:
            with open(para_json) as f:
                loaded = json.load(f)
            self.json_dict = loaded.get(model_id, loaded)
        else:
            self.json_dict = {}
        self.para_dict: Dict[str, Any] = {}

    def default_para_dict(self) -> Dict[str, Any]:
        from ptranking_tpu_torch.tree.lambdamart import DEFAULT_LIGHTGBM_PARAS

        lgbm_paras = dict(DEFAULT_LIGHTGBM_PARAS, eval_at=5)
        j = self.json_dict
        # reference json axis names -> lightgbm keys
        remap = {"BT": "boosting_type", "metric": "metric", "leaves": "num_leaves",
                 "trees": "num_trees", "MiData": "min_data_in_leaf",
                 "MSH": "min_sum_hessian_in_leaf", "LR": "learning_rate",
                 "eval_at": "eval_at"}
        for axis, key in remap.items():
            if axis in j:
                lgbm_paras[key] = _first(j[axis])
        custom = j.get("custom_dict", {"custom": False, "custom_obj_id": None})
        self.para_dict = dict(custom_dict=custom, lightgbm_para_dict=lgbm_paras)
        return self.para_dict

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        j = self.json_dict
        axes = dict(
            BT=_as_list(j.get("BT", ["gbdt"])),
            metric=_as_list(j.get("metric", ["ndcg"])),
            leaves=_as_list(j.get("leaves", [400])),
            trees=_as_list(j.get("trees", [1000])),
            MiData=_as_list(j.get("MiData", [50])),
            MSH=_as_list(j.get("MSH", [200])),
            # the reference's grid takes LR over [0.05, 0.01]
            LR=_as_list(j.get("LR", [0.05, 0.01])),
        )
        eval_at = _first(j.get("eval_at", 5))
        custom = j.get("custom_dict", {"custom": False, "custom_obj_id": None})
        keys = list(axes)
        for combo in itertools.product(*(axes[k] for k in keys)):
            c = dict(zip(keys, combo))
            lgbm_paras = {
                "boosting_type": c["BT"], "objective": "lambdarank",
                "metric": c["metric"], "learning_rate": c["LR"],
                "num_leaves": c["leaves"], "num_trees": c["trees"],
                "num_threads": 16, "min_data_in_leaf": c["MiData"],
                "min_sum_hessian_in_leaf": c["MSH"], "eval_at": eval_at,
                "verbosity": -1,
            }
            self.para_dict = dict(custom_dict=custom, lightgbm_para_dict=lgbm_paras)
            yield self.para_dict

    def get_identifier(self) -> str:
        d = self.para_dict or self.default_para_dict()
        custom = d["custom_dict"]
        if custom.get("custom") and custom.get("use_LGBMRanker"):
            return "_".join([self.model_id, "Custom", custom["custom_obj_id"]])
        if custom.get("custom"):
            return "_".join([self.model_id, "CustomFobj", custom["custom_obj_id"]])
        return self.model_id

    def to_para_string(self, log=False) -> str:
        d = (self.para_dict or self.default_para_dict())["lightgbm_para_dict"]
        s1, s2 = (":", "\n") if log else ("_", "_")
        return s2.join([
            s1.join(["BT", d["boosting_type"]]),
            s1.join(["Metric", d["metric"]]),
            s1.join(["Leaves", str(d["num_leaves"])]),
            s1.join(["Trees", str(d["num_trees"])]),
            s1.join(["MiData", f"{d['min_data_in_leaf']:g}"]),
            s1.join(["MSH", f"{d['min_sum_hessian_in_leaf']:g}"]),
            s1.join(["LR", f"{d['learning_rate']:g}"]),
            s1.join(["EvalAt", str(d.get("eval_at", 5))]),
        ])
