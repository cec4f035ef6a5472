"""LTREvaluator: the k-fold cross-validation experiment runner.

The port's copy of ptranking_tpu/eval/evaluator.py: load_data /
load_ranker / setup_output / kfold_cv_eval / kfold_cv_reproduce / grid_run
/ point_run / run, on one device (`device="cuda"` unless the caller asks
for the CPU), or, with a `mesh` eval setting, data-parallel over the ranks
of a process group through parallel/train.py::DistributedTrainer (the
same lifecycle: validation, best checkpoints, stop guard, resume). Under a
mesh only rank 0 writes the run directory's files, and decisions taken on
files (a resume state, a best checkpoint) are rank 0's, handed to every
rank; `tp`, `pp_stages`, `shard_docs` and `cp_impl` reach the
DistributedTrainer. Without a mesh the
multi-device companion keys (`tp`, `shard_docs`, `cp_impl`, `pp_stages`,
`eval_chunk`) change nothing, as in the JAX package. Training data is
device-resident by default (`maybe_device_resident`, bf16 features for a
bf16 scorer) and trained through `AdhocRanker.train_epoch_resident`; a
dataset over the budget is streamed through `prefetch_to_device`. The run directory's name encodes
every setting, as in the JAX package. A run resumes from its
`Fold-<k>/train_state.pt` (the ranker's checkpoint, the epoch and the
validation tape's best), the port's own `.pt`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.dataset import (BucketedDataset, make_synthetic_queries,
                                              random_mask_all_labels, random_mask_rele_labels)
from ptranking_tpu_torch.data.device_cache import (DEFAULT_BUDGET_BYTES, DeviceResidentDataset,
                                                   maybe_device_resident)
from ptranking_tpu_torch.data.letor import load_letor_file
from ptranking_tpu_torch.data.meta import ISTELLA_LTR, SYNTHETIC, YAHOO_LTR
from ptranking_tpu_torch.data.prefetch import prefetch_to_device
from ptranking_tpu_torch.eval.settings import DataSetting, EvalSetting, ModelSetting, SFSetting
from ptranking_tpu_torch.eval.tapes import (CVTape, OptLossTape, SummaryTape, ValidationTape,
                                            get_opt_model)
from ptranking_tpu_torch.parallel.collectives import is_writer
from ptranking_tpu_torch.train.ranker import AdhocRanker, torch_checkpoint
from ptranking_tpu_torch.utils.runlog import run_log

LTR_ADHOC_MODELS = [
    "RankMSE", "RankNet", "LambdaRank", "ListNet", "STListNet", "ListMLE",
    "RankCosine", "ApproxNDCG", "LambdaLoss", "SoftRank", "MDPRank",
    "WassRank", "DASALC", "NeuralNDCG",
]
TRAIN_STATE = "train_state.pt"


def _read_state(path: str):
    """A run's resume state, or None where there is none."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class LTREvaluator:
    """k-fold CV, grid search and reproduce runs of the adhoc rankers on one
    device or over a mesh."""

    def __init__(self, device="cuda", cuda: Optional[int] = None,
                 mesh_overrides: Optional[Dict[str, Any]] = None):
        if cuda is not None and torch.device(device).type == "cuda":
            device = f"cuda:{cuda}"
        self.device = resolve_device(device)
        # CLI-level overrides, merged into every eval_dict over JSON values
        self.mesh_overrides = mesh_overrides

    # ----------------------------------------------------------- file layout

    def determine_files(self, data_dict, fold_k: int) -> Tuple[str, Optional[str], str]:
        """(train, vali or None, test) file paths of fold `fold_k`."""
        data_id, dir_data = data_dict["data_id"], data_dict["dir_data"]
        if data_id in YAHOO_LTR:
            stem = data_id.lower()
            return (os.path.join(dir_data, f"{stem}.train.txt"),
                    os.path.join(dir_data, f"{stem}.valid.txt"),
                    os.path.join(dir_data, f"{stem}.test.txt"))
        if data_id in ISTELLA_LTR:
            vali = (os.path.join(dir_data, "vali.txt")
                    if data_id in ("Istella_X", "Istella_S") else None)
            return os.path.join(dir_data, "train.txt"), vali, os.path.join(dir_data, "test.txt")
        # everything else uses the Fold{k}/ layout; a single-fold dataset laid
        # out flat (train.txt at dir_data, no Fold1/) is accepted too
        fold_dir = os.path.join(dir_data, f"Fold{fold_k}")
        if (fold_k == 1 and not os.path.isdir(fold_dir)
                and os.path.exists(os.path.join(dir_data, "train.txt"))):
            fold_dir = dir_data
        vali = os.path.join(fold_dir, "vali.txt")
        return (os.path.join(fold_dir, "train.txt"),
                vali if os.path.exists(vali) or fold_dir != dir_data else None,
                os.path.join(fold_dir, "test.txt"))

    def load_data(self, eval_dict, data_dict, fold_k: int):
        """(train, test, vali or None): BucketedDatasets, device-resident on
        the evaluator's device when they fit the budget (the default)."""
        data_id = data_dict["data_id"]
        batch_docs = max(int(data_dict.get("tr_batch_size", 100)), 1)
        common = dict(
            has_comment=data_dict.get("has_comment"),
            min_docs=data_dict.get("min_docs"), min_rele=data_dict.get("min_rele", 1),
            binary_rele=data_dict.get("binary_rele", False),
            unknown_as_zero=data_dict.get("unknown_as_zero", False),
            scale_data=data_dict.get("scale_data"), scaler_id=data_dict.get("scaler_id"),
        )
        if data_id in SYNTHETIC:
            n = 60 if eval_dict.get("debug") else 400
            meta_f = data_dict["num_features"]
            mk = lambda seed: make_synthetic_queries(
                num_queries=n, num_features=meta_f, seed=seed,
                max_label=data_dict.get("max_rele_level") or 2,
                max_docs=40 if meta_f == 46 else 120,
            )
            train_qs, vali_qs, test_qs = mk(fold_k), mk(1000 + fold_k), mk(2000 + fold_k)
        else:
            f_train, f_vali, f_test = self.determine_files(data_dict, fold_k)
            train_qs = load_letor_file(f_train, data_id=data_id,
                                       presort=data_dict["train_presort"], **common)
            test_qs = load_letor_file(f_test, data_id=data_id,
                                      presort=data_dict["test_presort"], **common)
            vali_qs = (load_letor_file(f_vali, data_id=data_id,
                                       presort=data_dict["validation_presort"], **common)
                       if (eval_dict["do_validation"] or eval_dict["do_summary"]) and f_vali
                       else None)

        if eval_dict.get("mask_label"):
            masker = {"rand_mask_all": random_mask_all_labels,
                      "rand_mask_rele": random_mask_rele_labels}[eval_dict["mask_type"]]
            train_qs = masker(train_qs, eval_dict["mask_ratio"])

        F = data_dict["num_features"]
        # validation and test batches keep the reference's 100-doc rough
        # batches: BN takes batch statistics at evaluation, so a larger
        # batch would shift the normalisation away from training's
        vali_bd = int(data_dict.get("validation_rough_batch_size", 100))
        test_bd = int(data_dict.get("test_rough_batch_size", 100))
        train = BucketedDataset(train_qs, batch_docs=batch_docs, num_features=F,
                                seed=int(eval_dict.get("seed", 137)),
                                bucket_growth=float(data_dict.get("bucket_growth", 2.0)))
        test = BucketedDataset(test_qs, batch_docs=test_bd, num_features=F)
        vali = (BucketedDataset(vali_qs, batch_docs=vali_bd, num_features=F)
                if vali_qs is not None else None)
        if eval_dict.get("device_resident", True):
            budget = int(eval_dict.get("device_resident_bytes", DEFAULT_BUDGET_BYTES))
            dtype = eval_dict.get("device_resident_dtype")
            train, test = (maybe_device_resident(ds, budget, dtype, self.device)
                           for ds in (train, test))
            if vali is not None:
                vali = maybe_device_resident(vali, budget, dtype, self.device)
        return train, test, vali

    # -------------------------------------------------------------- rankers

    def load_ranker(self, sf_para, model_para_dict, label_type, eval_dict=None):
        """An AdhocRanker on the evaluator's device for the model's paras;
        with a `mesh` eval setting, a DistributedTrainer over that mesh (with
        its companion keys) instead, as the JAX package does."""
        eval_dict = eval_dict or {}
        model_id = model_para_dict["model_id"]
        paras = {k: v for k, v in model_para_dict.items() if k != "model_id"}
        if eval_dict.get("mesh"):
            from ptranking_tpu_torch.parallel.mesh import mesh_from_dict
            from ptranking_tpu_torch.parallel.train import DistributedTrainer

            kwargs = {k: eval_dict[k] for k in ("tp", "shard_docs", "cp_impl", "pp_stages",
                                                "scan_steps", "eval_chunk")
                      if eval_dict.get(k) is not None}
            return DistributedTrainer(model_id, sf_para["scorer"],
                                      mesh_from_dict(eval_dict["mesh"]), model_paras=paras,
                                      opt_cfg=sf_para["optimizer"], label_type=label_type,
                                      device=self.device, **kwargs)
        kwargs = {"scan_steps": eval_dict["scan_steps"]} if eval_dict.get("scan_steps") else {}
        return AdhocRanker(model_id, sf_para["scorer"], model_paras=paras,
                           opt_cfg=sf_para["optimizer"], label_type=label_type,
                           device=self.device, **kwargs)

    # --------------------------------------------------------------- output

    def setup_output(self, data_dict, eval_dict) -> str:
        """The run directory, whose name encodes every setting."""
        model_id = self.model_setting.model_id
        dir_output = eval_dict["dir_output"]
        dir_root = (os.path.join(dir_output, f"grid_{model_id}")
                    if eval_dict.get("grid_search") else dir_output)
        sf_str = self.sf_setting.to_para_string()
        data_eval_str = "_".join([
            self.data_setting.to_data_setting_string(),
            self.eval_setting.to_eval_setting_string(),
        ])
        if eval_dict.get("mask_label"):
            data_eval_str += f"_MaskLabel_Ratio_{eval_dict['mask_ratio']:g}"
        prefix = "_".join([model_id, "SF", sf_str, data_eval_str])
        if data_dict.get("scale_data"):
            level = "QS" if data_dict.get("scaler_level") == "QUERY" else "DS"
            prefix = "_".join([prefix, level, str(data_dict.get("scaler_id"))])
        dir_run = os.path.join(dir_root, prefix)
        model_str = self.model_setting.to_para_string()
        if model_str:
            dir_run = os.path.join(dir_run, model_str)
        if is_writer():
            os.makedirs(dir_run, exist_ok=True)
        return dir_run

    # ------------------------------------------------------------- training

    def kfold_cv_eval(self, data_dict, eval_dict, sf_para, model_para_dict) -> Dict[str, Any]:
        """Train and test every fold; returns the CV means {nDCG, nERR, AP, P:
        [len(cutoffs)], elapsed_s}. The run's output is teed to a log file in
        the run directory unless do_log is off or in debug mode."""
        with run_log(self.setup_output(data_dict, eval_dict),
                     enabled=eval_dict.get("do_log", True),
                     debug=eval_dict.get("debug", False)):
            return self._kfold_cv_eval(data_dict, eval_dict, sf_para, model_para_dict)

    def _kfold_cv_eval(self, data_dict, eval_dict, sf_para, model_para_dict) -> Dict[str, Any]:
        model_id = model_para_dict["model_id"]
        fold_num = data_dict["fold_num"]
        epochs = eval_dict["epochs"]
        do_vali = eval_dict["do_validation"]
        if data_dict["data_id"] == "Istella" and do_vali:
            raise ValueError("Istella has no validation split: set do_validation=False")
        cutoffs = eval_dict["cutoffs"]
        dir_run = self.setup_output(data_dict, eval_dict)

        # ApproxNDCG validates on nDCG
        if model_id == "ApproxNDCG" and do_vali:
            eval_dict["vali_metric"] = "nDCG"

        base_seed = int(eval_dict.get("seed", 137))
        cv_tape = CVTape(model_id, fold_num, cutoffs, do_vali)
        for fold_k in range(1, fold_num + 1):
            ranker = self.load_ranker(sf_para, model_para_dict,
                                      data_dict["label_type"], eval_dict)
            ranker.seed = base_seed + fold_k
            ranker.init()
            if (eval_dict.get("device_resident_dtype") is None
                    and getattr(sf_para["scorer"], "compute_dtype", None) == "bfloat16"):
                # a bf16 scorer casts features on entry: store them in bf16 too
                eval_dict = dict(eval_dict, device_resident_dtype="bfloat16")
            train, test, vali = self.load_data(eval_dict, data_dict, fold_k)
            vali_tape = (ValidationTape(fold_k, epochs, eval_dict["vali_metric"],
                                        eval_dict["vali_k"], dir_run) if do_vali else None)
            summary_tape = (SummaryTape(do_vali, dir_run, fold_k, cutoffs=cutoffs)
                            if eval_dict.get("do_summary") else None)
            loss_tape = OptLossTape() if eval_dict.get("loss_guided") else None

            # Resume: the state holds params, optimizer and generator state
            # and the epoch; an epoch's batch schedule depends on the epoch
            # alone, so restarting at epoch + 1 replays the same run.
            state_path = os.path.join(dir_run, f"Fold-{fold_k}", TRAIN_STATE)
            save_state = eval_dict.get("save_train_state", False)
            start_epoch = 1
            # under a mesh, rank 0 reads the state and hands it to every rank
            st = (ranker._dp.from_first(_read_state, state_path)
                  if eval_dict.get("resume") else None)
            if st is not None:
                ranker.restore(torch_checkpoint(st))
                start_epoch = int(st["epoch"]) + 1
                if vali_tape is not None:
                    vali_tape.best_value = st.get("best_value", vali_tape.best_value)
                    vali_tape.best_epoch = st.get("best_epoch", vali_tape.best_epoch)
                print(f"  [fold {fold_k}] resuming from epoch {start_epoch}")

            resident = isinstance(train, DeviceResidentDataset)
            train_s, fold_queries, epochs_ran = 0.0, 0, 0
            for epoch_k in range(start_epoch, epochs + 1):
                t_ep = time.time()
                if resident:
                    epoch_loss, stop = ranker.train_epoch_resident(train, epoch_k)
                else:
                    batches = train.batches(shuffle=True, epoch=epoch_k)
                    if not eval_dict.get("mesh"):
                        # a mesh trainer copies its block of each batch itself
                        batches = prefetch_to_device(batches, device=self.device)
                    epoch_loss, stop = ranker.train_epoch(batches, epoch_k=epoch_k)
                train_s += time.time() - t_ep  # the training window only
                if stop:
                    print("training is failed !")
                    break
                epochs_ran += 1
                fold_queries += train.num_queries
                if do_vali and (epoch_k % eval_dict.get("log_step", 1) == 0 or epoch_k == 1):
                    v = ranker.validation(vali, k=eval_dict["vali_k"],
                                          metric=eval_dict["vali_metric"])
                    vali_tape.epoch_validation(epoch_k, v, ranker)
                    if summary_tape:
                        summary_tape.epoch_summary(epoch_loss, v, ranker=ranker,
                                                   train_data=train, test_data=test)
                elif summary_tape:
                    summary_tape.epoch_summary(epoch_loss, ranker=ranker,
                                               train_data=train, test_data=test)
                if save_state or eval_dict.get("resume"):
                    # every rank makes the state (a tensor-parallel trainer
                    # joins its shards); rank 0 writes it
                    ck = ranker.checkpoint()
                    ck["epoch"] = epoch_k
                    if vali_tape is not None:
                        ck["best_value"] = vali_tape.best_value
                        ck["best_epoch"] = vali_tape.best_epoch
                    if is_writer():
                        tmp = state_path + ".tmp"
                        os.makedirs(os.path.dirname(state_path), exist_ok=True)
                        torch.save(ck, tmp)
                        os.replace(tmp, state_path)  # atomic: never a torn state
                if loss_tape and loss_tape.epoch_cmp_loss(epoch_loss):
                    break

            if do_vali:
                opt_path = vali_tape.get_optimal_path()
                if ranker._dp.from_first(os.path.exists, opt_path):
                    ranker.load(opt_path)
                else:
                    # no epoch improved validation (NaN scores from epoch 1):
                    # evaluate the current params
                    print("  [warn] no validation checkpoint was saved; "
                          "evaluating the final-epoch params")
                vali_tape.clear_fold_buffer()
            else:
                ranker.save(os.path.join(dir_run, f"Fold-{fold_k}", "net_params_latest.pt"))
            if summary_tape:
                summary_tape.fold_summary(train_data_length=train.num_queries)
            if eval_dict.get("do_log", True) and epochs_ran:
                print(f"  [fold {fold_k}] {fold_queries / max(train_s, 1e-9):,.0f}"
                      f" lists/s (training) over {epochs_ran} epochs")
            cv_tape.fold_evaluation(ranker, test, fold_k)

        return cv_tape.get_cv_performance()

    def kfold_cv_reproduce(self, data_dict, eval_dict, sf_para, model_para_dict):
        """Reload each fold's best checkpoint and evaluate it again, writing
        the per-query metric matrices."""
        model_id = model_para_dict["model_id"]
        fold_num = data_dict["fold_num"]
        dir_run = self.setup_output(data_dict, eval_dict)
        cv_tape = CVTape(model_id, fold_num, eval_dict["cutoffs"], eval_dict["do_validation"],
                         reproduce=True, dir_run=dir_run)
        for fold_k in range(1, fold_num + 1):
            ranker = self.load_ranker(sf_para, model_para_dict,
                                      data_dict["label_type"], eval_dict)
            ranker.init()
            ckpt = ranker._dp.from_first(get_opt_model, os.path.join(dir_run, f"Fold-{fold_k}"))
            if not ckpt:
                raise FileNotFoundError(f"no checkpoint for fold {fold_k} under {dir_run}")
            ranker.load(ckpt)
            _, test, _ = self.load_data(eval_dict, data_dict, fold_k)
            cv_tape.fold_evaluation(ranker, test, fold_k)
        return cv_tape.get_cv_performance()

    # ------------------------------------------------------------ dispatch

    def set_settings(self, debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json):
        if dir_json:
            data_eval_sf_json = os.path.join(dir_json, "Data_Eval_ScoringFunction.json")
            para_json = os.path.join(dir_json, f"{model_id}Parameter.json")
            self.data_setting = DataSetting(debug, data_json=data_eval_sf_json)
            self.eval_setting = EvalSetting(debug, eval_json=data_eval_sf_json,
                                            overrides=self.mesh_overrides)
            self.sf_setting = SFSetting(debug, sf_id=sf_id, sf_json=data_eval_sf_json)
            self.model_setting = ModelSetting(model_id, debug, para_json=para_json)
        else:
            self.data_setting = DataSetting(debug, data_id=data_id, dir_data=dir_data)
            self.eval_setting = EvalSetting(debug, dir_output=dir_output,
                                            overrides=self.mesh_overrides)
            self.sf_setting = SFSetting(debug, sf_id=sf_id)
            self.model_setting = ModelSetting(model_id, debug)

    def point_run(self, debug=False, model_id=None, sf_id="pointsf", data_id=None,
                  dir_data=None, dir_output="./output", dir_json=None, reproduce=False):
        """One setting: its defaults (or the JSON's first values)."""
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        data_dict = self.data_setting.default_setting()
        eval_dict = self.eval_setting.default_setting()
        sf_para = self.sf_setting.default_setting(data_dict["num_features"])
        model_para = {"model_id": model_id, **self.model_setting.default_para_dict()}
        if reproduce:
            return self.kfold_cv_reproduce(data_dict, eval_dict, sf_para, model_para)
        return self.kfold_cv_eval(data_dict, eval_dict, sf_para, model_para)

    def grid_run(self, debug=False, model_id=None, sf_id="pointsf", data_id=None,
                 dir_data=None, dir_output="./output", dir_json=None):
        """Grid search over the data x eval x scorer x model settings; writes
        the best setting by nDCG@vali_k."""
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        best_value, best_setting, best_perf = -np.inf, None, None
        for data_dict in self.data_setting.grid_search():
            for eval_dict in self.eval_setting.grid_search():
                for sf_para in self.sf_setting.grid_search(data_dict["num_features"]):
                    for model_para in self.model_setting.grid_search():
                        mp = {"model_id": model_id, **model_para}
                        perf = self.kfold_cv_eval(data_dict, eval_dict, sf_para, mp)
                        vali_k = eval_dict.get("vali_k") or 5
                        k_idx = (eval_dict["cutoffs"].index(vali_k)
                                 if vali_k in eval_dict["cutoffs"] else 0)
                        val = float(perf["nDCG"][k_idx])
                        if val > best_value:
                            best_value = val
                            best_setting = (dict(data_dict), dict(eval_dict), sf_para, mp)
                            best_perf = perf
        if best_setting is not None:
            self._log_max(best_setting, best_value)
        return best_perf

    def _log_max(self, setting, value):
        """Write the best grid setting beside the run directories."""
        data_dict, eval_dict, sf_para, model_para = setting
        if not is_writer():
            return
        dir_output = eval_dict["dir_output"]
        os.makedirs(dir_output, exist_ok=True)
        path = os.path.join(dir_output, f"{data_dict['data_id']}_{sf_para['scorer'].sf_id}_max.txt")
        with open(path, "w") as f:
            f.write(f"best nDCG@vali_k: {value:.6f}\n")
            f.write(f"model: {model_para}\nscorer: {sf_para['scorer']}\n")
            f.write(f"optimizer: {sf_para['optimizer']}\ndata: {data_dict}\n")

    def run(self, debug=False, model_id=None, sf_id="pointsf", config_with_json=False,
            dir_json=None, data_id=None, dir_data=None, dir_output="./output",
            grid_search=False, reproduce=False):
        """Entry point: JSON configs always run the grid (or reproduce)."""
        if model_id not in LTR_ADHOC_MODELS:
            raise ValueError(f"{model_id!r} not in {LTR_ADHOC_MODELS}")
        if config_with_json:
            if dir_json is None:
                raise ValueError("config_with_json needs dir_json")
            if reproduce:
                return self.point_run(debug, model_id, sf_id, dir_json=dir_json, reproduce=True)
            return self.grid_run(debug, model_id, sf_id, dir_json=dir_json)
        if grid_search:
            return self.grid_run(debug, model_id, sf_id, data_id, dir_data, dir_output)
        return self.point_run(debug, model_id, sf_id, data_id, dir_data, dir_output,
                              reproduce=reproduce)
