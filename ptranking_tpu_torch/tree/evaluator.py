"""TreeLTREvaluator: the tree branch's k-fold runs, on one device.

Counterpart of ptranking_tpu/tree/evaluator.py: flat (data, target, group)
arrays a fold, LightGBM training with nDCG@5 early stopping, or, where
LightGBM is absent, the native GBDT (tree/gbdt.py, model id
TPUGBDTLambdaMART) growing its trees on the evaluator's device; test metrics
from the flat predictions (`cal_metric_at_ks`, on the device's metrics);
grid_run / point_run / run over TreeDataSetting, TreeEvalSetting and
TreeModelSetting. The device is `cuda` unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.dataset import make_synthetic_queries
from ptranking_tpu_torch.data.letor import load_letor_file
from ptranking_tpu_torch.metrics.adhoc import evaluate_all_at_ks
from ptranking_tpu_torch.tree.gbdt import GBDTConfig, GBDTRanker
from ptranking_tpu_torch.tree.lambdamart import HAS_LIGHTGBM, LightGBMLambdaMART, queries_to_flat
from ptranking_tpu_torch.tree.settings import (
    TREE_MODEL_IDS,
    TreeDataSetting,
    TreeEvalSetting,
    TreeModelSetting,
)
from ptranking_tpu_torch.utils.runlog import run_log

LTR_TREE_MODELS = TREE_MODEL_IDS


def cal_metric_at_ks(preds: np.ndarray, labels: np.ndarray, group: np.ndarray,
                     ks=(1, 3, 5, 10, 20, 50), device="cuda") -> Dict[str, np.ndarray]:
    """Mean metrics over the queries of flat arrays: the lists padded into one
    batch and scored by the port's metrics on `device`."""
    group = np.asarray(group).astype(int)
    n_max = int(group.max()) if len(group) else 1
    B = len(group)
    scores = np.full((B, n_max), -1e9, np.float32)
    lab = np.zeros((B, n_max), np.float32)
    mask = np.zeros((B, n_max), bool)
    head = 0
    for i, g in enumerate(group):
        scores[i, :g] = preds[head:head + g]
        lab[i, :g] = labels[head:head + g]
        mask[i, :g] = True
        head += g
    dev = resolve_device(device)
    out = evaluate_all_at_ks(torch.from_numpy(scores).to(dev), torch.from_numpy(lab).to(dev),
                             torch.from_numpy(mask).to(dev), tuple(ks))
    return {m: out[m].cpu().numpy().mean(axis=0) for m in ("nDCG", "nERR", "AP", "P")}


class TreeLTREvaluator:
    """The tree branch's k-fold runs on one device (`device="cuda"` unless the
    caller asks for the CPU)."""

    def __init__(self, device="cuda", cuda: Optional[int] = None):
        if cuda is not None and torch.device(device).type == "cuda":
            device = f"cuda:{cuda}"
        self.device = resolve_device(device)

    # --------------------------------------------------------------- output

    def setup_output(self, data_dict, eval_dict) -> str:
        model_str = self.model_setting.get_identifier()
        dir_output = eval_dict["dir_output"]
        dir_root = (os.path.join(dir_output, f"grid_{model_str}")
                    if eval_dict.get("grid_search") else dir_output)
        prefix = "_".join([model_str,
                           self.data_setting.to_data_setting_string(),
                           self.eval_setting.to_eval_setting_string()])
        dir_run = os.path.join(dir_root, prefix, self.model_setting.to_para_string())
        os.makedirs(dir_run, exist_ok=True)
        return dir_run

    # ------------------------------------------------------------- training

    def kfold_cv_eval(self, data_dict, eval_dict, model_para_dict) -> Dict[str, np.ndarray]:
        """The k-fold loop over settings dicts; the run's output is teed to a
        timestamped log in the run directory."""
        with run_log(self.setup_output(data_dict, eval_dict),
                     enabled=eval_dict.get("do_log", True),
                     debug=eval_dict.get("debug", False)):
            return self._kfold_cv_eval(data_dict, eval_dict, model_para_dict)

    def _kfold_cv_eval(self, data_dict, eval_dict, model_para_dict) -> Dict[str, np.ndarray]:
        model_id = self.model_setting.model_id
        if model_id == "LightGBMLambdaMART" and not HAS_LIGHTGBM:
            # fall back to the native GBDT so the branch always runs
            print(" [tree] lightgbm unavailable -> using the native TPUGBDTLambdaMART")
            model_id = "TPUGBDTLambdaMART"
        data_id = data_dict["data_id"]
        fold_num = data_dict["fold_num"]
        cutoffs = tuple(eval_dict["cutoffs"])
        early_stop = int(eval_dict["early_stop_or_boost_round"])
        dir_run = self.setup_output(data_dict, eval_dict)

        fold_results: List[Dict[str, np.ndarray]] = []
        for fold_k in range(1, fold_num + 1):
            if data_id.startswith("Synthetic"):
                n = 40 if eval_dict.get("debug") else 400
                mk = lambda s: make_synthetic_queries(
                    num_queries=n, num_features=data_dict["num_features"], seed=s)
                train_qs, vali_qs, test_qs = mk(fold_k), mk(1000 + fold_k), mk(2000 + fold_k)
            else:
                fold_dir = os.path.join(data_dict["dir_data"], f"Fold{fold_k}")
                common = dict(data_id=data_id, min_docs=data_dict.get("min_docs"),
                              min_rele=data_dict.get("min_rele", 1),
                              binary_rele=data_dict.get("binary_rele", False),
                              unknown_as_zero=data_dict.get("unknown_as_zero", False),
                              presort=False)
                ld = lambda name: load_letor_file(os.path.join(fold_dir, name), **common)
                train_qs, vali_qs, test_qs = ld("train.txt"), ld("vali.txt"), ld("test.txt")
            if model_id == "TPUGBDTLambdaMART":
                cfg = GBDTConfig.from_paras(model_para_dict,
                                            early_stopping_rounds=early_stop)
                if eval_dict.get("debug"):
                    cfg.num_trees = min(cfg.num_trees, 50)
                model = GBDTRanker(cfg, device=str(self.device))
                model.fit(*queries_to_flat(train_qs), vali=queries_to_flat(vali_qs))
                model.save(os.path.join(dir_run, f"fold_{fold_k}.model"))
            else:
                model = LightGBMLambdaMART(model_para_dict)
                model.fit(queries_to_flat(train_qs), queries_to_flat(vali_qs),
                          early_stopping_rounds=early_stop)
                model.save_model(os.path.join(dir_run, f"fold_{fold_k}.model"))
            x_test, y_test, g_test = queries_to_flat(test_qs)
            y_pred = model.predict(x_test)
            m = cal_metric_at_ks(y_pred, y_test, g_test, ks=cutoffs, device=self.device)
            fold_results.append(m)
            print(f" Fold-{fold_k} {model_id} test nDCG: "
                  + ", ".join(f"@{k}:{v:.4f}" for k, v in zip(cutoffs, m["nDCG"])))
        cv = {k: np.mean(np.stack([m[k] for m in fold_results]), axis=0)
              for k in fold_results[0]}
        k_rep = 5 if 5 in cutoffs else cutoffs[0]
        print(f"\n{model_id} {fold_num}-fold CV nDCG@{k_rep}: "
              f"{cv['nDCG'][list(cutoffs).index(k_rep)]:.4f}")
        return cv

    # ------------------------------------------------------------ dispatch

    def set_settings(self, debug, model_id, data_id, dir_data, dir_output, dir_json):
        if dir_json:
            tree_json = os.path.join(dir_json, "Tree_Data_Eval_ScoringFunction.json")
            para_json = os.path.join(dir_json, f"{model_id}Parameter.json")
            self.data_setting = TreeDataSetting(debug, data_json=tree_json)
            self.eval_setting = TreeEvalSetting(debug, eval_json=tree_json)
            self.model_setting = TreeModelSetting(model_id, debug, para_json=para_json)
        else:
            self.data_setting = TreeDataSetting(debug, data_id=data_id, dir_data=dir_data)
            self.eval_setting = TreeEvalSetting(debug, dir_output=dir_output)
            self.model_setting = TreeModelSetting(model_id, debug)

    def point_run(self, debug=False, model_id="LightGBMLambdaMART", data_id=None,
                  dir_data=None, dir_output="./tree_output", dir_json=None,
                  para_dict: Optional[dict] = None):
        self.set_settings(debug, model_id, data_id, dir_data, dir_output, dir_json)
        data_dict = self.data_setting.default_setting()
        eval_dict = self.eval_setting.default_setting()
        mp = self.model_setting.default_para_dict()
        if para_dict:
            mp = dict(mp)
            mp["lightgbm_para_dict"] = {**mp["lightgbm_para_dict"],
                                        **para_dict.get("lightgbm_para_dict", {})}
            if "custom_dict" in para_dict:
                mp["custom_dict"] = para_dict["custom_dict"]
            self.model_setting.para_dict = mp
        return self.kfold_cv_eval(data_dict, eval_dict, mp)

    def grid_run(self, debug=False, model_id="LightGBMLambdaMART", data_id=None,
                 dir_data=None, dir_output="./tree_output", dir_json=None):
        self.set_settings(debug, model_id, data_id, dir_data, dir_output, dir_json)
        best_value, best_cv = -np.inf, None
        for data_dict in self.data_setting.grid_search():
            for eval_dict in self.eval_setting.grid_search():
                for mp in self.model_setting.grid_search():
                    cv = self.kfold_cv_eval(data_dict, eval_dict, mp)
                    ks = list(eval_dict["cutoffs"])
                    k_idx = ks.index(5) if 5 in ks else 0
                    val = float(cv["nDCG"][k_idx])
                    if val > best_value:
                        best_value, best_cv = val, cv
        return best_cv

    def run(self, debug=False, model_id="LightGBMLambdaMART", config_with_json=False,
            dir_json=None, data_id=None, dir_data=None, dir_output="./tree_output",
            grid_search=False):
        if model_id not in LTR_TREE_MODELS:
            raise ValueError(f"{model_id!r} is not a tree model id ({LTR_TREE_MODELS})")
        if config_with_json:
            if dir_json is None:
                raise ValueError("config_with_json needs dir_json")
            return self.grid_run(debug, model_id, dir_json=dir_json)
        if grid_search:
            return self.grid_run(debug, model_id, data_id, dir_data, dir_output)
        return self.point_run(debug, model_id, data_id, dir_data, dir_output)
