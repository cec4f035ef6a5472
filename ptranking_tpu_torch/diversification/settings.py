"""Diversification-branch settings: JSON, grids and para strings, and the
branch's tapes.

The port's copy of ptranking_tpu/diversification/settings.py: the same JSON
schema (Div_Data_Eval_ScoringFunction.json with DivDataSetting,
DivEvalSetting and DivSFParameter sections, and <Model>Parameter.json), the
same defaults (pointsf Adagrad lr 1e-3, listsf Adagrad lr 1e-2 AttnDIN 6 x
6, 500 epochs, validation on aNDCG@5), the same grids and run-directory
names, built on the port's DivScorerConfig and OptimizerConfig. DivCVTape
aggregates aNDCG, ERR-IA and nERR-IA over the folds and, in reproduce mode,
the ndeval oracle's columns and the per-query aNDCG matrix.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ptranking_tpu_torch.diversification.data import get_div_data_meta
from ptranking_tpu_torch.diversification.scorers import DivScorerConfig
from ptranking_tpu_torch.eval.settings import _as_list, _first
from ptranking_tpu_torch.parallel.collectives import is_writer
from ptranking_tpu_torch.train.optimizer import OptimizerConfig

DIV_DEFAULT_PARAS: Dict[str, dict] = {
    # reference DALETORParameter (daletor.py:73-125): rt=10, top_k=10
    "DALETOR": {"rt": 10.0, "top_k": 10},
    # reference DivProbRankerParameter (div_prob_ranker.py:364-460)
    "DivProbRanker": {"opt_id": "SuperSoft", "metric": "aNDCG", "top_k": 10,
                      "opt_ideal": True, "K": 1, "cluster": False,
                      "sort_id": "ExpRele", "limit_delta": None, "norm": True},
}


class DivDataSetting:
    """Reference DivDataSetting (div_parameter.py:392-464)."""

    JSON_SECTION = "DivDataSetting"

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

    def _base(self) -> Dict[str, Any]:
        meta = dict(get_div_data_meta(self.data_id))
        meta["fold_num"] = 2 if self.debug else meta["fold_num"]
        return dict(data_id=self.data_id, dir_data=self.dir_data,
                    debug=self.debug, **meta)

    def default_setting(self) -> Dict[str, Any]:
        j = self.json_dict
        add_noise = _first(j.get("add_noise", False))
        d = self._base()
        d.update(add_noise=add_noise,
                 std_delta=_first(j.get("std_delta", 1.0)) if add_noise else None)
        self.data_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        j = self.json_dict
        for add_noise in _as_list(j.get("add_noise", [False])):
            stds = _as_list(j.get("std_delta", [1.0])) if add_noise else [None]
            for std_delta in stds:
                d = self._base()
                d.update(add_noise=add_noise, std_delta=std_delta)
                self.data_dict = d
                yield d

    def to_data_setting_string(self, log=False) -> str:
        d = self.data_dict
        s = d["data_id"]
        if d.get("add_noise"):
            s = "_".join([s, "Gaussian", f"{d['std_delta']:g}"])
        return s


class DivEvalSetting:
    """Reference DivEvalSetting (div_parameter.py:253-390)."""

    JSON_SECTION = "DivEvalSetting"

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
        epochs = 5 if self.debug else _first(j.get("epochs", 500))
        do_validation = _first(j.get("do_validation", True))
        rerank = _first(j.get("rerank", False))
        d = dict(
            debug=self.debug, grid_search=False, dir_output=self.dir_output,
            epochs=epochs, do_validation=do_validation,
            vali_k=_first(j.get("vali_k", 5)) if do_validation else None,
            vali_metric=_first(j.get("vali_metric", "aNDCG")) if do_validation else None,
            cutoffs=j.get("cutoffs", [1, 3, 5, 10, 20]),
            do_log=_first(j.get("do_log", not self.debug)),
            log_step=_first(j.get("log_step", 1)),
            do_summary=_first(j.get("do_summary", False)),
            loss_guided=_first(j.get("loss_guided", False)),
            rerank=rerank,
            rerank_k=_first(j.get("rerank_k", 50)) if rerank else None,
            rerank_dir=_first(j.get("rerank_dir")) if rerank else None,
            rerank_model_id=_first(j.get("rerank_model_id")) if rerank else None,
            rerank_model_dir=_first(j.get("rerank_model_dir")) if rerank else None,
        )
        # the resident-data knobs and `mesh` (the ranker's data parallelism)
        for k in ("mesh", "device_resident", "device_resident_bytes"):
            if k in j:
                d[k] = j[k] if k == "mesh" else _first(j[k])
        self.eval_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        d = self.default_setting()
        d["grid_search"] = True
        self.eval_dict = d
        yield d

    def to_eval_setting_string(self, log=False) -> str:
        d = self.eval_dict
        s1 = ":" if log else "_"
        if d["do_validation"]:
            s = s1.join(["EP", str(d["epochs"]), "V",
                         f"{d['vali_metric']}@{d['vali_k']}"])
        else:
            s = s1.join(["epochs", str(d["epochs"])])
        if d.get("rerank"):
            s = s1.join([s, "RR", str(d["rerank_k"]), str(d["rerank_model_id"])])
        return s


class DivSFSetting:
    """Reference DivScoringFunctionParameter (div_parameter.py:16-251):
    pointsf Adagrad lr 1e-3 GE-FFN; listsf Adagrad lr 1e-2 AttnDIN 6x6."""

    JSON_SECTION = "DivSFParameter"

    def __init__(self, debug=False, sf_id="pointsf", sf_json=None):
        self.debug = debug
        self.sf_id = sf_id
        self.use_json = sf_json is not None
        if self.use_json:
            with open(sf_json) as f:
                self.json_dict = json.load(f)[self.JSON_SECTION]
            self.sf_id = self.json_dict.get("sf_id", sf_id)
        else:
            self.json_dict = {}
        self.sf_para: Dict[str, Any] = {}

    def _make(self, num_features: int, c: Dict[str, Any], opt: str, lr: float):
        base = c.get("sf_id", self.sf_id)
        if base.startswith("pointsf"):
            cfg = DivScorerConfig(
                sf_id=base, num_features=num_features,
                num_layers=c.get("layers", 5), AF=c.get("AF", "GE"),
                TL_AF=c.get("TL_AF", "GE"), apply_tl_af=c.get("apply_tl_af", False),
                BN=c.get("BN", True), bn_type=c.get("bn_type", "BN"),
                bn_affine=c.get("bn_affine", True),
                K=c.get("K", 1), cluster=c.get("cluster", False),
                sort_id=c.get("sort_id", "ExpRele"), limit_delta=c.get("limit_delta"),
                dropout=c.get("dropout", 0.1),
            )
        else:
            cfg = DivScorerConfig(
                sf_id=base, num_features=num_features,
                ff_dims=tuple(c.get("ff_dims", (256, 128, 64))),
                n_heads=c.get("n_heads", 6), encoder_layers=c.get("encoder_layers", 6),
                encoder_type=c.get("encoder_type", "AttnDIN"),
                AF=c.get("AF", "R"), TL_AF=c.get("TL_AF", "GE"),
                apply_tl_af=c.get("apply_tl_af", False),
                BN=c.get("BN", True), bn_type=c.get("bn_type", "BN"),
                bn_affine=c.get("bn_affine", True),
                K=c.get("K", 1), cluster=c.get("cluster", False),
                sort_id=c.get("sort_id", "ExpRele"), limit_delta=c.get("limit_delta"),
                dropout=c.get("dropout", 0.1),
            )
        self.sf_para = {"scorer": cfg, "optimizer": OptimizerConfig(opt=opt, lr=lr)}
        return self.sf_para

    def default_setting(self, num_features: int = 100):
        j = self.json_dict
        sub = {k: _first(v) for k, v in j.get(self.sf_id, {}).items()}
        if "ff_dims" in j.get(self.sf_id, {}):
            sub["ff_dims"] = j[self.sf_id]["ff_dims"]
        default_lr = 1e-3 if self.sf_id.startswith("pointsf") else 1e-2
        return self._make(num_features, sub, _first(j.get("opt", "Adagrad")),
                          _first(j.get("lr", default_lr)))

    def grid_search(self, num_features: int = 100):
        j = self.json_dict
        sub = j.get(self.sf_id, {})
        opts = _as_list(j.get("opt", ["Adagrad"]))
        default_lr = 1e-3 if self.sf_id.startswith("pointsf") else 1e-2
        lrs = _as_list(j.get("lr", [default_lr]))
        axes = {k: _as_list(v) for k, v in sub.items() if k != "ff_dims"}
        keys = list(axes)
        for opt, lr in itertools.product(opts, lrs):
            for combo in itertools.product(*(axes[k] for k in keys)) if keys else [()]:
                c = dict(zip(keys, combo))
                if "ff_dims" in sub:
                    c["ff_dims"] = sub["ff_dims"]
                yield self._make(num_features, c, opt, lr)

    def to_para_string(self, log=False) -> str:
        cfg: DivScorerConfig = self.sf_para["scorer"]
        opt: OptimizerConfig = self.sf_para["optimizer"]
        if cfg.sf_id.startswith("pointsf"):
            n_layers = cfg.num_layers
        else:
            n_layers = len(cfg.ff_dims)
        tl = cfg.TL_AF if cfg.apply_tl_af else "No"
        parts = [cfg.AF + str(n_layers) + tl, opt.opt, f"Lr{opt.lr:g}"]
        if cfg.BN:
            parts.append(cfg.bn_type)
        if not cfg.sf_id.startswith("pointsf"):
            parts.append(f"{cfg.encoder_type}E{cfg.encoder_layers}H{cfg.n_heads}")
        return "_".join(parts)


class DivModelSetting:
    """Per-model defaults/grids/para-strings (reference DALETORParameter,
    DivProbRankerParameter)."""

    def __init__(self, model_id: str, debug=False, para_json=None):
        if model_id not in DIV_DEFAULT_PARAS:
            raise ValueError(f"{model_id!r} not in {sorted(DIV_DEFAULT_PARAS)}")
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
        d = dict(DIV_DEFAULT_PARAS[self.model_id])
        for k, v in self.json_dict.items():
            d[k] = _first(v)
        self.para_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        j = self.json_dict
        if self.model_id == "DALETOR":
            # reference grid (daletor.py:115-125): rt x top_k
            for rt, top_k in itertools.product(_as_list(j.get("rt", [10.0])),
                                               _as_list(j.get("top_k", [10]))):
                self.para_dict = dict(DIV_DEFAULT_PARAS["DALETOR"], rt=rt, top_k=top_k)
                yield self.para_dict
            return
        # DivProbRanker nested grid (div_prob_ranker.py:439-480): opt_id gates
        # which inner axes apply
        choice_K = _as_list(j.get("K", [5] if not self.debug else [1]))
        choice_cluster = _as_list(j.get("cluster", [False]))
        choice_opt_id = _as_list(j.get("opt_id", ["SuperSoft"] if self.debug
                                       else ["SuperSoft", "PairCLS", "LambdaPairCLS"]))
        choice_sort = _as_list(j.get("sort_id", ["ExpRele"]))
        choice_delta = _as_list(j.get("limit_delta", [None, 0.1]))
        choice_topk = _as_list(j.get("top_k", [10]))
        choice_metric = _as_list(j.get("metric", ["aNDCG"]))
        choice_ideal = _as_list(j.get("opt_ideal", [True]))
        choice_norm = _as_list(j.get("norm", [True]))
        for K, cluster, opt_id, sort_id, limit_delta in itertools.product(
                choice_K, choice_cluster, choice_opt_id, choice_sort, choice_delta):
            base = dict(DIV_DEFAULT_PARAS["DivProbRanker"], K=K, cluster=cluster,
                        opt_id=opt_id, sort_id=sort_id, limit_delta=limit_delta)
            if opt_id == "PairCLS":
                self.para_dict = base
                yield self.para_dict
            elif opt_id == "LambdaPairCLS":
                for opt_ideal, norm in itertools.product(choice_ideal, choice_norm):
                    self.para_dict = dict(base, opt_ideal=opt_ideal, norm=norm)
                    yield self.para_dict
            else:  # SuperSoft
                for top_k, metric, opt_ideal in itertools.product(
                        choice_topk, choice_metric, choice_ideal):
                    self.para_dict = dict(base, top_k=top_k, metric=metric,
                                          opt_ideal=opt_ideal)
                    yield self.para_dict

    def to_para_string(self, log=False) -> str:
        d = self.para_dict or self.default_para_dict()
        s1 = ":" if log else "_"
        if self.model_id == "DALETOR":
            # reference daletor.py to_para_string
            topk = "Full" if d.get("top_k") is None else str(d["top_k"])
            return s1.join(["rt", str(d["rt"]), "topk", topk])
        # DivProbRanker (div_prob_ranker.py:395-437)
        parts = [str(d["K"])]
        if d.get("cluster"):
            parts.append("CS")
        parts += [d["opt_id"], d["sort_id"]]
        if d.get("limit_delta") is not None:
            parts.append(f"{d['limit_delta']:g}")
        if d["opt_id"] == "LambdaPairCLS":
            if d.get("norm"):
                parts.append("Norm")
            if d.get("opt_ideal"):
                parts.append("OptIdeal")
        elif d["opt_id"] == "SuperSoft":
            if d.get("opt_ideal"):
                parts.append("OptIdeal")
            parts.append("Full" if d.get("top_k") is None else str(d["top_k"]))
        return s1.join(parts)


# ---------------------------------------------------------------- div tapes


class DivCVTape:
    """Fold-wise aNDCG/ERR-IA/nERR-IA aggregation (reference DivCVTape,
    div_parameter.py:467-618); reproduce mode adds the ndeval oracle columns
    and pickles the per-query aNDCG matrix."""

    METRICS = ("aNDCG", "ERR-IA", "nERR-IA")

    def __init__(self, model_id: str, fold_num: int, cutoffs, do_validation: bool,
                 reproduce: bool = False, dir_run: Optional[str] = None):
        self.model_id = model_id
        self.fold_num = fold_num
        self.cutoffs = list(cutoffs)
        self.do_validation = do_validation
        self.reproduce = reproduce
        self.dir_run = dir_run
        self.per_fold: Dict[str, List[np.ndarray]] = {m: [] for m in self.METRICS}
        self.ndeval_cutoffs = [5, 10, 20]
        self.ndeval_per_fold: Dict[str, List[np.ndarray]] = {m: [] for m in self.METRICS}
        self.list_per_q_andcg: List[np.ndarray] = []

    def fold_evaluation(self, ranker, test_batches, fold_k: int):
        m = ranker.evaluate(test_batches, ks=tuple(self.cutoffs))
        for name in self.METRICS:
            self.per_fold[name].append(np.asarray(m[name]))
        row = ", ".join(f"aNDCG@{k}:{v:.4f}" for k, v in zip(self.cutoffs, m["aNDCG"]))
        print(f"\n Fold-{fold_k} {self.model_id} test: {row}")
        return m

    def fold_ndeval(self, amean: Dict[str, float], per_q_andcg: Optional[np.ndarray] = None):
        """Record one fold's ndeval-oracle row (reproduce mode; reference
        fold_evaluation_reproduce, div_parameter.py:510-571)."""
        self.ndeval_per_fold["ERR-IA"].append(
            np.asarray([amean[f"ERR-IA@{k}"] for k in self.ndeval_cutoffs]))
        self.ndeval_per_fold["nERR-IA"].append(
            np.asarray([amean[f"nERR-IA@{k}"] for k in self.ndeval_cutoffs]))
        self.ndeval_per_fold["aNDCG"].append(
            np.asarray([amean[f"alpha-nDCG@{k}"] for k in self.ndeval_cutoffs]))
        if per_q_andcg is not None:
            self.list_per_q_andcg.append(np.asarray(per_q_andcg))

    def get_cv_performance(self) -> Dict[str, np.ndarray]:
        cv = {m: np.mean(np.stack(v), axis=0) for m, v in self.per_fold.items() if v}
        print(f"\n{self.model_id} {self.fold_num}-fold CV:")
        for m in self.METRICS:
            if m in cv:
                print("  " + ", ".join(f"{m}@{k}:{v:.4f}"
                                       for k, v in zip(self.cutoffs, cv[m])))
        if self.reproduce and self.ndeval_per_fold["aNDCG"]:
            for m in self.METRICS:
                nd = np.mean(np.stack(self.ndeval_per_fold[m]), axis=0)
                cv[f"{m}(ndeval)"] = nd
                print("  " + ", ".join(f"{m}(ndeval)@{k}:{v:.4f}"
                                       for k, v in zip(self.ndeval_cutoffs, nd)))
        if self.reproduce and self.dir_run and self.list_per_q_andcg and is_writer():
            import pickle

            mat = np.concatenate(self.list_per_q_andcg, axis=0)
            path = os.path.join(self.dir_run,
                                f"{self.model_id}_all_fold_andcg_at_ks_per_q.np")
            with open(path, "wb") as f:
                pickle.dump(mat, f, protocol=pickle.HIGHEST_PROTOCOL)
        return cv


class DivSummaryTape:
    """Per-epoch loss + train/vali/test aNDCG@ks tracks (reference
    DivSummaryTape, div_parameter.py:620-643)."""

    def __init__(self, do_validation: bool, cutoffs, dir_run: str, fold_k: int):
        self.do_validation = do_validation
        self.cutoffs = tuple(cutoffs)
        self.dir_run = dir_run
        self.fold_k = fold_k
        self.list_epoch_loss: List[float] = []
        self.list_vali: List[np.ndarray] = []
        self.list_train: List[np.ndarray] = []
        self.list_test: List[np.ndarray] = []

    def epoch_summary(self, epoch_loss: float, ranker, train_data, vali_data, test_data):
        self.list_epoch_loss.append(float(epoch_loss))
        self.list_train.append(np.asarray(
            ranker.evaluate(train_data, ks=self.cutoffs)["aNDCG"]))
        self.list_test.append(np.asarray(
            ranker.evaluate(test_data, ks=self.cutoffs)["aNDCG"]))
        if self.do_validation:
            self.list_vali.append(np.asarray(
                ranker.evaluate(vali_data, ks=self.cutoffs)["aNDCG"]))

    def fold_summary(self, train_data_length: Optional[int] = None):
        import pickle

        if not is_writer():
            return
        prefix = os.path.join(self.dir_run, f"Fold_{self.fold_k}")

        def save(obj, suffix):
            with open("_".join([prefix, suffix]), "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

        if self.do_validation and self.list_vali:
            save(np.vstack(self.list_vali), "vali_eval.np")
        if self.list_train:
            save(np.vstack(self.list_train), "train_eval.np")
        if self.list_test:
            save(np.vstack(self.list_test), "test_eval.np")
        save((np.asarray(self.list_epoch_loss), train_data_length), "epoch_loss.np")
