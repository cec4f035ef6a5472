"""Three-source configuration: CLI -> JSON -> dataclass defaults.

The port's copy of ptranking_tpu/eval/settings.py: the same JSON schema
(configs/Data_Eval_ScoringFunction.json + <Model>Parameter.json), the same
defaults, the same grids and the same run-directory names, built on the
port's ScorerConfig and OptimizerConfig. JSON list values are grid axes;
`default` takes element [0]. The multi-device keys (`mesh`, `tp`,
`shard_docs`, `cp_impl`, `pp_stages`, `eval_chunk`) are parsed and named in
the run directory as the JAX package does. Only `mesh` changes a run: the
others are read where it is set.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, Iterator, List, Optional

from ptranking_tpu_torch.data.meta import get_data_meta, get_scaler_setting
from ptranking_tpu_torch.losses import DEFAULT_PARAS
from ptranking_tpu_torch.models import ScorerConfig
from ptranking_tpu_torch.train.optimizer import OptimizerConfig

def _as_list(v):
    """JSON grid axes may arrive as scalars; normalize to a 1-element list
    (a bare string must NOT iterate per character)."""
    return v if isinstance(v, list) else [v]


def _first(v):
    return v[0] if isinstance(v, list) else v


# --------------------------------------------------------------------- data


class DataSetting:
    """Reference DataSetting (parameter.py:514-648)."""

    def __init__(self, debug=False, data_id=None, dir_data=None, data_json=None):
        self.debug = debug
        self.use_json = data_json is not None
        if self.use_json:
            with open(data_json) as f:
                self.json_dict = json.load(f)["DataSetting"]
            self.data_id = self.json_dict["data_id"]
            self.dir_data = self.json_dict["dir_data"]
        else:
            self.json_dict = {}
            self.data_id = data_id
            self.dir_data = dir_data
        self.data_dict: Dict[str, Any] = {}

    def _base(self) -> Dict[str, Any]:
        # generic GLTR ids (LTR_LibSVM/LETOR) read their meta from the JSON
        # data section (reference data_utils.py:46-67 format contract)
        meta = get_data_meta(self.data_id, json_dict=self.json_dict)
        scale_data, scaler_id, scaler_level = get_scaler_setting(
            self.data_id, _first(self.json_dict.get("scaler_id"))
        )
        return dict(
            data_id=self.data_id,
            dir_data=self.dir_data,
            num_features=meta.num_features,
            has_comment=meta.has_comment,
            label_type=meta.label_type,
            max_rele_level=meta.max_rele_level,
            fold_num=2 if self.debug else meta.fold_num,
            scale_data=scale_data,
            scaler_id=scaler_id,
            scaler_level=scaler_level,
            train_presort=True,
            validation_presort=True,
            test_presort=True,
        )

    def default_setting(self) -> Dict[str, Any]:
        d = self._base()
        j = self.json_dict
        d.update(
            min_docs=_first(j.get("min_docs", 10)),
            min_rele=_first(j.get("min_rele", 1)),
            binary_rele=_first(j.get("binary_rele", False)),
            unknown_as_zero=_first(j.get("unknown_as_zero", False)),
            # docs a training batch (the reference's train_rough_batch_size)
            tr_batch_size=_first(j.get("tr_batch_size", 100)),
            # reference hard-codes 100-doc vali/test batches (parameter.py:581,590)
            validation_rough_batch_size=_first(j.get("validation_rough_batch_size", 100)),
            test_rough_batch_size=_first(j.get("test_rough_batch_size", 100)),
            # train bucket-width growth factor (2.0 = powers of two; 1.5 or
            # 1.25 = denser widths, less padding, more batch shapes)
            bucket_growth=float(_first(j.get("bucket_growth", 2.0))),
        )
        self.data_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        j = self.json_dict
        choices = dict(
            min_docs=_as_list(j.get("min_docs", [10])),
            min_rele=_as_list(j.get("min_rele", [1])),
            binary_rele=_as_list(j.get("binary_rele", [False])),
            unknown_as_zero=_as_list(j.get("unknown_as_zero", [False])),
            tr_batch_size=_as_list(j.get("tr_batch_size", [100])),
        )
        passthrough = dict(
            validation_rough_batch_size=_first(j.get("validation_rough_batch_size", 100)),
            test_rough_batch_size=_first(j.get("test_rough_batch_size", 100)),
        )
        keys = list(choices)
        for combo in itertools.product(*(choices[k] for k in keys)):
            d = self._base()
            d.update(passthrough)
            d.update(dict(zip(keys, combo)))
            self.data_dict = d
            yield d

    def to_data_setting_string(self, log=False) -> str:
        d = self.data_dict
        s1 = ":" if log else "_"
        parts = [d["data_id"], s1.join(["MiD", str(d["min_docs"])]),
                 s1.join(["MiR", str(d["min_rele"])]),
                 s1.join(["TrBat", str(d["tr_batch_size"])])]
        if d.get("bucket_growth", 2.0) != 2.0:  # result-changing batch former
            parts.append("BG" + str(d["bucket_growth"]))
        if d.get("binary_rele"):
            parts.append("BiRele")
        if d.get("unknown_as_zero"):
            parts.append("UO")
        return "_".join(parts)


# --------------------------------------------------------------------- eval


class EvalSetting:
    """Reference EvalSetting (parameter.py:374-511)."""

    def __init__(self, debug=False, dir_output=None, eval_json=None,
                 overrides: Optional[Dict[str, Any]] = None):
        self.debug = debug
        self.use_json = eval_json is not None
        if self.use_json:
            with open(eval_json) as f:
                self.json_dict = json.load(f)["EvalSetting"]
            self.dir_output = self.json_dict["dir_output"]
        else:
            self.json_dict = {}
            self.dir_output = dir_output
        # CLI-level overrides (e.g. `-mesh data=8`) win over JSON values —
        # the standard three-source precedence (CLI > JSON > defaults)
        self.overrides = dict(overrides or {})
        self.eval_dict: Dict[str, Any] = {}

    def default_setting(self) -> Dict[str, Any]:
        j = self.json_dict
        mask = j.get("mask", {})
        epochs = _first(j.get("epochs", 5 if self.debug else 100))
        do_validation = _first(j.get("do_validation", True))
        d = dict(
            debug=self.debug,
            grid_search=False,
            dir_output=self.dir_output,
            epochs=epochs,
            do_validation=do_validation,
            vali_k=_first(j.get("vali_k", 5)) if do_validation else None,
            vali_metric=_first(j.get("vali_metric", "nDCG")) if do_validation else None,
            cutoffs=j.get("cutoffs", [1, 3, 5, 10, 20, 50]),
            do_log=_first(j.get("do_log", not self.debug)),
            log_step=_first(j.get("log_step", 1)),
            do_summary=_first(j.get("do_summary", False)),
            loss_guided=_first(j.get("loss_guided", False)),
            mask_label=_first(mask.get("mask_label", False)),
            mask_type=_first(mask.get("mask_type", "rand_mask_all")),
            mask_ratio=_first(mask.get("mask_ratio", 0.2)),
        )
        # device-resident knobs: on/off, device budget, and the features'
        # storage dtype (None = fp32 / "bfloat16" / "int8" affine-quantized)
        # `seed` (base init+shuffle seed, default 137) is threaded so the
        # parity harness / band tests can run multi-seed realisations
        for k in ("device_resident", "device_resident_bytes",
                  "device_resident_dtype", "save_train_state", "resume",
                  "seed"):
            if k in j:
                d[k] = _first(j[k])
        # multi-device knobs (a `mesh` axis-size dict and its companions) and
        # scan_steps (batches an index chunk of the resident epoch)
        for k in ("mesh", "tp", "shard_docs", "cp_impl", "pp_stages",
                  "scan_steps", "eval_chunk"):
            if k in j:
                d[k] = j[k] if k == "mesh" else _first(j[k])
        d.update(self.overrides)
        self.eval_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        d = self.default_setting()
        d["grid_search"] = True
        j = self.json_dict
        epochs_axis = [5] if self.debug else _as_list(j.get("epochs", d["epochs"]))
        vali_k_axis = _as_list(j.get("vali_k", d["vali_k"] or 5))
        mask = j.get("mask", {})
        if d["mask_label"]:
            mask_axes = itertools.product(_as_list(mask.get("mask_type", ["rand_mask_all"])),
                                          _as_list(mask.get("mask_ratio", [0.2])))
        else:
            mask_axes = [(d["mask_type"], d["mask_ratio"])]
        for epochs, vali_k, (t, r) in itertools.product(epochs_axis, vali_k_axis, mask_axes):
            d2 = dict(d, epochs=epochs, mask_type=t, mask_ratio=r)
            if d["do_validation"]:
                d2["vali_k"] = vali_k
            self.eval_dict = d2
            yield d2

    def to_eval_setting_string(self, log=False) -> str:
        d = self.eval_dict
        s1 = ":" if log else "_"
        parts = (["EP", str(d["epochs"]), "V", f"{d['vali_metric']}@{d['vali_k']}"]
                 if d["do_validation"] else ["epochs", str(d["epochs"])])
        # the run-dir name must encode every result-changing setting: an
        # explicit resident feature dtype alters training numerics, so fp32
        # and bf16/int8 runs must not share an output directory
        if d.get("device_resident_dtype"):
            parts += ["R" + str(d["device_resident_dtype"])]
        if d.get("seed") not in (None, 137):  # non-default seed changes results
            parts += ["S" + str(d["seed"])]
        if d.get("mesh"):
            m = d["mesh"]
            tok = "Mesh" + "".join(f"{ax[0]}{m[ax]}" for ax in
                                   ("dcn", "data", "model", "seq") if m.get(ax))
            if d.get("tp"):
                tok += "TP"
            if d.get("shard_docs"):
                tok += "CP" + str(d.get("cp_impl", "ring"))
            if d.get("pp_stages"):
                tok += f"PP{d['pp_stages']}"
            parts += [tok]
        return s1.join(parts)


# ----------------------------------------------------------------- scorer


class SFSetting:
    """Reference ScoringFunctionParameter (parameter.py:74-371): pointsf and
    listsf defaults/grids + optimizer choice, yielding ScorerConfig +
    OptimizerConfig pairs."""

    def __init__(self, debug=False, sf_id="pointsf", sf_json=None):
        self.debug = debug
        self.sf_id = sf_id
        self.use_json = sf_json is not None
        if self.use_json:
            with open(sf_json) as f:
                self.json_dict = json.load(f)["SFParameter"]
            self.sf_id = self.json_dict.get("sf_id", sf_id)
        else:
            self.json_dict = {}
        self.sf_para: Dict[str, Any] = {}

    def default_setting(self, num_features: int):
        j = self.json_dict
        sub = j.get(self.sf_id, {})
        if self.sf_id.startswith("pointsf"):
            # defaults: parameter.py:139-148
            cfg = ScorerConfig(
                sf_id="pointsf", num_features=num_features,
                num_layers=_first(sub.get("layers", 5)),
                AF=_first(sub.get("AF", "GE")),
                TL_AF=_first(sub.get("TL_AF", sub.get("tl_af", "S"))),
                apply_tl_af=_first(sub.get("apply_tl_af", True)),
                BN=_first(sub.get("BN", True)), bn_type=_first(sub.get("bn_type", "BN")),
                bn_affine=_first(sub.get("bn_affine", True)),
                dropout=_first(sub.get("dropout", 0.1)),
            )
            opt = OptimizerConfig(opt=_first(j.get("opt", "Adam")), lr=_first(j.get("lr", 1e-4)))
        else:
            # defaults: parameter.py:152-166
            cfg = ScorerConfig.default_listsf(
                num_features,
                ff_dims=tuple(sub.get("ff_dims", [128, 256, 512])),
                AF=_first(sub.get("AF", "R")),
                TL_AF=_first(sub.get("TL_AF", sub.get("tl_af", "GE"))),
                apply_tl_af=_first(sub.get("apply_tl_af", False)),
                BN=_first(sub.get("BN", False)), bn_type=_first(sub.get("bn_type", "BN2")),
                bn_affine=_first(sub.get("bn_affine", False)),
                n_heads=_first(sub.get("n_heads", 2)),
                encoder_layers=_first(sub.get("encoder_layers", 6)),
                encoder_type=_first(sub.get("encoder_type", "DASALC")),
                dropout=_first(sub.get("dropout", 0.1)),
                compute_dtype=_first(sub.get("compute_dtype", "float32")),
                lane_align=_first(sub.get("lane_align", False)),
                flash_attn=_first(sub.get("flash_attn", False)),
                attn_block_size=_first(sub.get("attn_block_size", None)),
                remat=_first(sub.get("remat", False)),
            )
            opt = OptimizerConfig(opt=_first(j.get("opt", "Adagrad")), lr=_first(j.get("lr", 1e-3)))
        self.sf_para = {"scorer": cfg, "optimizer": opt}
        return self.sf_para

    def grid_search(self, num_features: int):
        """Built-in (non-json) grids mirror the reference's non-debug choice
        lists (pointsf_grid_search/listsf_grid_search, parameter.py:168-290):
        AF/TL_AF over ['R','CE','S'] (['R','CE'] in debug), Adam 1e-3, BN2
        non-affine. JSON axes override everything."""
        j = self.json_dict
        sub = j.get(self.sf_id, {})
        af_default = ["R", "CE"] if self.debug else ["R", "CE", "S"]
        opts = _as_list(j.get("opt", ["Adam"]))
        lrs = _as_list(j.get("lr", [1e-3]))
        if self.sf_id.startswith("pointsf"):
            axes = dict(
                layers=sub.get("layers", [3] if self.debug else [5]),
                AF=sub.get("AF", af_default),
                TL_AF=sub.get("TL_AF", sub.get("tl_af", af_default)),
                apply_tl_af=sub.get("apply_tl_af", [True]),
                BN=sub.get("BN", [True]), bn_type=sub.get("bn_type", ["BN2"]),
                bn_affine=sub.get("bn_affine", [False]),
            )
            axes = {k: _as_list(v) for k, v in axes.items()}
            for opt, lr in itertools.product(opts, lrs):
                keys = list(axes)
                for combo in itertools.product(*(axes[k] for k in keys)):
                    c = dict(zip(keys, combo))
                    cfg = ScorerConfig(
                        sf_id="pointsf", num_features=num_features, num_layers=c["layers"],
                        AF=c["AF"], TL_AF=c["TL_AF"], apply_tl_af=c["apply_tl_af"],
                        BN=c["BN"], bn_type=c["bn_type"], bn_affine=c["bn_affine"],
                    )
                    self.sf_para = {"scorer": cfg, "optimizer": OptimizerConfig(opt=opt, lr=lr)}
                    yield self.sf_para
        else:
            axes = dict(
                AF=sub.get("AF", af_default),
                TL_AF=sub.get("TL_AF", sub.get("tl_af", af_default)),
                apply_tl_af=sub.get("apply_tl_af", [True]),
                BN=sub.get("BN", [True]),
                bn_type=sub.get("bn_type", ["BN2"]), bn_affine=sub.get("bn_affine", [False]),
                n_heads=sub.get("n_heads", [2]),
                encoder_layers=sub.get("encoder_layers", [3]),
                encoder_type=sub.get("encoder_type", ["DASALC"]),
                compute_dtype=sub.get("compute_dtype", ["float32"]),
                lane_align=sub.get("lane_align", [False]),
                flash_attn=sub.get("flash_attn", [False]),
                attn_block_size=sub.get("attn_block_size", [None]),
                remat=sub.get("remat", [False]),
            )
            axes = {k: _as_list(v) for k, v in axes.items()}
            ff_dims = tuple(sub.get("ff_dims", [128, 256, 512]))
            for opt, lr in itertools.product(opts, lrs):
                keys = list(axes)
                for combo in itertools.product(*(axes[k] for k in keys)):
                    c = dict(zip(keys, combo))
                    cfg = ScorerConfig.default_listsf(num_features, ff_dims=ff_dims, **c)
                    self.sf_para = {"scorer": cfg, "optimizer": OptimizerConfig(opt=opt, lr=lr)}
                    yield self.sf_para

    def to_para_string(self, log=False) -> str:
        cfg: ScorerConfig = self.sf_para["scorer"]
        opt: OptimizerConfig = self.sf_para["optimizer"]
        n_layers = cfg.num_layers if cfg.sf_id.startswith("pointsf") else len(cfg.ff_dims)
        tl = cfg.TL_AF if cfg.apply_tl_af else "No"
        parts = [cfg.AF + str(n_layers) + tl, opt.opt, f"Lr{opt.lr:g}"]
        if cfg.BN:
            parts.append(cfg.bn_type)
        if cfg.dropout != 0.1:  # non-default dropout is result-changing
            parts.append(f"Drop{cfg.dropout:g}")
        if not cfg.sf_id.startswith("pointsf"):
            parts.append(f"{cfg.encoder_type}E{cfg.encoder_layers}H{cfg.n_heads}")
            if cfg.lane_align:
                parts.append(f"Lane{cfg.width}")
            if cfg.compute_dtype != "float32":  # result-changing: own run dir
                parts.append(str(cfg.compute_dtype))
            if cfg.flash_attn:  # result-changing under dropout (attention-
                parts.append("Flash")  # prob dropout is skipped on this path)
        return "_".join(parts)


# ----------------------------------------------------------------- model


# Grid-search axes per model. Non-debug lists mirror each reference
# <Model>Parameter.grid_search else-branch verbatim (e.g. ranknet.py:73-84
# sigma [1.0]; mdprank.py top_k [10], temperature [1.0]; wassRank.py
# wass_choice_* lists); MODEL_GRIDS_DEBUG carries the reference's debug
# variants. JSON axes override everything.
MODEL_GRIDS: Dict[str, Dict[str, List[Any]]] = {
    "RankMSE": {},
    "RankNet": {"sigma": [1.0]},
    "LambdaRank": {"sigma": [1.0]},
    "ListNet": {},
    "STListNet": {"temperature": [1.0]},
    "ListMLE": {},
    "RankCosine": {},
    "ApproxNDCG": {"alpha": [10.0]},
    "LambdaLoss": {"loss_type": ["NDCG_Loss2"], "k": [5], "sigma": [1.0], "mu": [5.0]},
    "SoftRank": {"delta": [1.0], "top_k": [None], "metric": ["nDCG"]},
    "MDPRank": {"distribution": ["PL"], "temperature": [1.0], "gamma": [1.0], "top_k": [10]},
    # reference wassRank.py grid_search else-branch: WassLossSta/10 itr/0.1
    # lam/eg cost/gap 10/penalty e/base 4 (our mode ids name the same solver)
    "WassRank": {"mode": ["SinkhornOT"], "sh_itr": [10], "lam": [0.1], "cost_type": ["eg"],
                 "smooth_type": ["ST"], "norm_type": ["BothST"], "non_rele_gap": [10],
                 "var_penalty": [2.718281828459045], "gain_base": [4]},
    "DASALC": {},
    # beyond-reference model (no reference grid to mirror)
    "NeuralNDCG": {"temperature": [1.0], "top_k": [None], "sinkhorn_iters": [10]},
}

# Debug-mode grid shrinks/variants (each reference grid_search debug branch).
MODEL_GRIDS_DEBUG: Dict[str, Dict[str, List[Any]]] = {
    "RankNet": {"sigma": [5.0, 1.0]},
    "LambdaRank": {"sigma": [5.0, 1.0]},
    "SoftRank": {"delta": [5.0, 1.0]},
    "MDPRank": {"temperature": [0.1]},
}


class ModelSetting:
    """Per-model hyper-parameter defaults/grids (reference ModelParameter,
    parameter.py:39-71 + each model file's Parameter class)."""

    def __init__(self, model_id: str, debug=False, para_json=None):
        self.model_id = model_id
        self.debug = debug
        self.use_json = para_json is not None and os.path.exists(para_json or "")
        if self.use_json:
            with open(para_json) as f:
                self.json_dict = json.load(f).get(model_id, {})
        else:
            self.json_dict = {}
        self.defaults = dict(DEFAULT_PARAS[model_id])
        self.para_dict: Dict[str, Any] = {}

    def default_para_dict(self) -> Dict[str, Any]:
        d = dict(self.defaults)
        for k, v in self.json_dict.items():
            d[k] = _first(v)
        self.para_dict = d
        return d

    def grid_search(self) -> Iterator[Dict[str, Any]]:
        axes = {k: _as_list(v) for k, v in MODEL_GRIDS[self.model_id].items()}
        if self.debug:
            for k, v in MODEL_GRIDS_DEBUG.get(self.model_id, {}).items():
                axes[k] = _as_list(v)
        for k, v in self.json_dict.items():
            axes[k] = _as_list(v)
        if not axes:
            self.para_dict = dict(self.defaults)
            yield self.para_dict
            return
        keys = list(axes)
        for combo in itertools.product(*(axes[k] for k in keys)):
            d = dict(self.defaults)
            d.update(dict(zip(keys, combo)))
            # reference nuance (lambdaloss.py grid_search): mu only applies
            # to the NDCG_Loss2++ loss type
            if self.model_id == "LambdaLoss" and d.get("loss_type") != "NDCG_Loss2++":
                d.pop("mu", None)
            self.para_dict = d
            yield d

    def to_para_string(self, log=False) -> str:
        if not self.para_dict:
            return ""
        skip = {"metric", "norm_type"}
        parts = [f"{k}{v:g}" if isinstance(v, float) else f"{k}{v}"
                 for k, v in sorted(self.para_dict.items()) if k not in skip and v is not None]
        return "_".join(parts)
