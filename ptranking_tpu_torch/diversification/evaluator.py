"""DivLTREvaluator: the k-fold cross-validation runner of the
diversification branch, and the TREC artifacts ndeval reads.

The port's copy of ptranking_tpu/diversification/evaluator.py, on one device
(`device="cuda"` unless the caller asks for the CPU): fold splits
(SyntheticDiv, or TREC Web Track folds from folder{k}/config.yml), the
training, validation and test data device-resident by default, per-epoch
validation on aNDCG@5 with the fold's best checkpoint (the port's `.pt`),
rerank mode, reproduce mode with the ndeval oracle's columns, the TREC run
and qrels writers (real docnos carried end to end), and the three-source
config stack (grid_run / point_run / run). The ndeval cross-check is
advisory: a missing toolchain or a failed run prints a line and the run
goes on. A `mesh` setting is refused until the multi-device layer is
ported (ROADMAP queue A item 8).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.device_cache import (DEFAULT_BUDGET_BYTES, DivDeviceResidentDataset,
                                                   maybe_div_device_resident)
from ptranking_tpu_torch.diversification.data import (
    DIV_SYNTHETIC,
    DivBucketedDataset,
    DivQuery,
    load_trec_div_fold,
    make_synthetic_div_queries,
    rerank_queries,
)
from ptranking_tpu_torch.diversification.ranker import DIV_MODELS, DivRanker
from ptranking_tpu_torch.diversification.settings import (
    DivCVTape,
    DivDataSetting,
    DivEvalSetting,
    DivModelSetting,
    DivSFSetting,
    DivSummaryTape,
)
from ptranking_tpu_torch.eval.tapes import ValidationTape, get_opt_model
from ptranking_tpu_torch.metrics.ndeval import ndeval_binary, run_ndeval
from ptranking_tpu_torch.utils.runlog import run_log


def build_topic_map(queries: Sequence[DivQuery]) -> Dict[str, str]:
    """Bijective qid -> TREC topic number map. ndeval's qrels parser requires
    natural-number topics; real WT qids already carry unique numbers, which we
    preserve (digit extraction) — but only when collision-free. Otherwise
    topics are enumerated in query order, still bijectively."""
    def trailing_digits(qid: str) -> Optional[str]:
        digits = ""
        for c in reversed(str(qid)):
            if c.isdigit():
                digits = c + digits
            elif digits:
                break
        return str(int(digits)) if digits else None

    qids = [str(q.qid) for q in queries]
    extracted = {q: trailing_digits(q) for q in qids}
    vals = [v for v in extracted.values() if v is not None]
    if len(vals) == len(qids) and len(set(vals)) == len(qids):
        return extracted
    return {q: str(i + 1) for i, q in enumerate(qids)}


def write_trec_run(path: str, topic: str, docids: Sequence[str],
                   scores: Sequence[float], system: str = "ptranking_tpu"):
    """TREC run rows: topic Q0 docid rank score system (reference
    base/ranker.py:437-443)."""
    with open(path, "a") as f:
        for rank, (d, s) in enumerate(zip(docids, scores), start=1):
            f.write(f"{topic} Q0 {d} {rank} {s:.6f} {system}\n")


def write_div_qrels(path: str, queries: Sequence[DivQuery],
                    topic_map: Optional[Dict[str, str]] = None):
    """Diversity qrels rows: topic subtopic docid relevance (reference qrels
    writer, ltr_diversification.py:114-152), using each query's REAL docnos."""
    topic_map = topic_map or build_topic_map(queries)
    with open(path, "w") as f:
        for q in queries:
            S, N = q.rele_mat.shape
            docnos = q.docnos if q.docnos is not None else [f"doc{d}" for d in range(N)]
            topic = topic_map[str(q.qid)]
            for s in range(S):
                for d in range(N):
                    f.write(f"{topic} {s + 1} {docnos[d]} {int(q.rele_mat[s, d])}\n")


class DivLTREvaluator:
    """k-fold CV, grid search and reproduce runs of the diversification
    rankers on one device."""

    def __init__(self, device="cuda", cuda: Optional[int] = None):
        if cuda is not None and torch.device(device).type == "cuda":
            device = f"cuda:{cuda}"
        self.device = resolve_device(device)

    # ----------------------------------------------------------------- data

    def load_fold(self, data_dict, fold_k: int):
        data_id = data_dict["data_id"]
        if data_id in DIV_SYNTHETIC:
            n = 24 if data_dict.get("debug") else 120
            noise = dict(add_noise=data_dict.get("add_noise", False),
                         std_delta=data_dict.get("std_delta") or 1.0)
            mk = lambda seed: _with_noise(
                make_synthetic_div_queries(num_queries=n, seed=seed), seed, **noise)
            return mk(fold_k), mk(1000 + fold_k), mk(2000 + fold_k)
        # TREC WT: fold qid lists from folder{k}/config.yml (train/vali/test)
        dir_data = data_dict["dir_data"]
        fold_dir = os.path.join(dir_data, f"folder{fold_k}")
        cfg_path = os.path.join(fold_dir, "config.yml")
        split = _load_fold_yaml(cfg_path)
        noise = dict(add_noise=data_dict.get("add_noise", False),
                     std_delta=data_dict.get("std_delta") or 1.0)
        return tuple(
            load_trec_div_fold(dir_data, split[name], presort=True, **noise)
            for name in ("train", "vali", "test")
        )

    # --------------------------------------------------------------- output

    def setup_output(self, data_dict, eval_dict) -> str:
        model_id = self.model_setting.model_id
        dir_output = eval_dict["dir_output"]
        dir_root = (os.path.join(dir_output, f"grid_{model_id}")
                    if eval_dict.get("grid_search") else dir_output)
        prefix = "_".join([model_id, "SF", self.sf_setting.to_para_string(),
                           self.data_setting.to_data_setting_string(),
                           self.eval_setting.to_eval_setting_string()])
        dir_run = os.path.join(dir_root, prefix, self.model_setting.to_para_string())
        os.makedirs(dir_run, exist_ok=True)
        return dir_run

    # ------------------------------------------------------------- training

    def div_cv_eval(self, data_dict, eval_dict, sf_para, model_para_dict,
                    reproduce: bool = False, write_run_files: bool = False):
        """The core CV loop over settings dicts (reference div_cv_eval,
        ltr_diversification.py:304-378); run output is teed to a timestamped
        log in the run dir (reference redirect, ltr_diversification.py:260-262)."""
        with run_log(self.setup_output(data_dict, eval_dict),
                     enabled=eval_dict.get("do_log", True),
                     debug=eval_dict.get("debug", False)):
            return self._div_cv_eval(data_dict, eval_dict, sf_para,
                                     model_para_dict, reproduce, write_run_files)

    def _div_cv_eval(self, data_dict, eval_dict, sf_para, model_para_dict,
                     reproduce: bool = False, write_run_files: bool = False):
        model_id = model_para_dict["model_id"]
        if model_id not in DIV_MODELS:
            raise ValueError(f"{model_id!r} not in {DIV_MODELS}")
        if eval_dict.get("mesh"):
            raise NotImplementedError(
                "the eval setting 'mesh' needs the multi-device layer, which the port does "
                "not have yet (ROADMAP queue A item 8)")
        fold_num = data_dict["fold_num"]
        epochs = eval_dict["epochs"]
        do_vali = eval_dict["do_validation"]
        do_summary = eval_dict.get("do_summary", False)
        vali_k = eval_dict.get("vali_k") or 5
        vali_metric = eval_dict.get("vali_metric") or "aNDCG"
        cutoffs = tuple(eval_dict["cutoffs"])
        paras = {k: v for k, v in model_para_dict.items() if k != "model_id"}
        scorer_cfg = sf_para["scorer"]
        # model paras override the MDN-head knobs on the scorer config
        scorer_cfg = dataclasses.replace(
            scorer_cfg, K=paras.get("K", scorer_cfg.K),
            cluster=paras.get("cluster", scorer_cfg.cluster),
            sort_id=paras.get("sort_id", scorer_cfg.sort_id),
            limit_delta=paras.get("limit_delta", scorer_cfg.limit_delta))
        opt_cfg = sf_para["optimizer"]
        dir_run = self.setup_output(data_dict, eval_dict)
        batch_queries = int(eval_dict.get("batch_queries", 8))

        cv_tape = DivCVTape(model_id, fold_num, cutoffs, do_vali,
                            reproduce=reproduce, dir_run=dir_run)
        for fold_k in range(1, fold_num + 1):
            train_qs, vali_qs, test_qs = self.load_fold(data_dict, fold_k)
            if eval_dict.get("rerank"):
                # 2-stage mode (reference ltr_diversification.py:296-303,
                # 323-339): a pretrained 1st-stage discriminator keeps only
                # its top-k docs per query before 2nd-stage training
                disc = DivRanker(model_id, scorer_cfg, model_paras=paras,
                                 opt_cfg=opt_cfg, seed=1 + fold_k, device=self.device).init()
                if eval_dict.get("rerank_model_dir"):
                    disc.load(str(eval_dict["rerank_model_dir"]).format(fold=fold_k))
                rerank_k = eval_dict.get("rerank_k") or 50
                train_qs = rerank_queries(train_qs, disc, rerank_k)
                vali_qs = rerank_queries(vali_qs, disc, rerank_k)
                test_qs = rerank_queries(test_qs, disc, rerank_k)
            train = DivBucketedDataset(train_qs, batch_queries=batch_queries)
            vali = DivBucketedDataset(vali_qs, batch_queries=batch_queries)
            test = DivBucketedDataset(test_qs, batch_queries=batch_queries)
            if eval_dict.get("device_resident", True):
                # uploaded once when within the budget; an epoch then copies
                # index chunks only
                budget = int(eval_dict.get("device_resident_bytes", DEFAULT_BUDGET_BYTES))
                train, vali, test_res = (maybe_div_device_resident(ds, budget, self.device)
                                         for ds in (train, vali, test))
            else:
                test_res = test
            ranker = DivRanker(model_id, scorer_cfg, model_paras=paras,
                               opt_cfg=opt_cfg, seed=137 + fold_k,
                               device=self.device).init()
            if reproduce:
                ckpt = get_opt_model(os.path.join(dir_run, f"Fold-{fold_k}"))
                if not ckpt:
                    raise FileNotFoundError(f"no checkpoint for fold {fold_k} under {dir_run}")
                ranker.load(ckpt)
                cv_tape.fold_evaluation(ranker, test_res, fold_k)
                amean, per_q = self._write_fold_run(ranker, test, test_qs, dir_run, fold_k,
                                                    need_per_q=True)
                if amean is not None:
                    cv_tape.fold_ndeval(amean, per_q)
                continue

            tape = ValidationTape(fold_k, epochs, vali_metric, vali_k, dir_run)
            summary = (DivSummaryTape(do_vali, cutoffs, dir_run, fold_k)
                       if do_summary else None)
            resident = isinstance(train, DivDeviceResidentDataset)
            for epoch_k in range(1, epochs + 1):
                if resident:
                    epoch_loss, stop = ranker.train_epoch_resident(train, epoch_k)
                else:
                    epoch_loss, stop = ranker.train_epoch(
                        train.batches(shuffle=True, epoch=epoch_k), epoch_k)
                if stop:
                    print("training is failed !")
                    break
                if do_vali:
                    v = ranker.validation(vali, k=vali_k, metric=vali_metric)
                    tape.epoch_validation(epoch_k, v, ranker)
                if summary:
                    summary.epoch_summary(epoch_loss, ranker, train, vali, test_res)
            if do_vali:
                opt_path = tape.get_optimal_path()
                if os.path.exists(opt_path):
                    ranker.load(opt_path)
                else:
                    print("  [warn] no validation checkpoint was saved; "
                          "evaluating the final-epoch params")
                tape.clear_fold_buffer()
            else:
                ranker.save(os.path.join(dir_run, f"Fold-{fold_k}",
                                         f"net_params_epoch_{epochs}.pt"))
            if summary:
                summary.fold_summary(train_data_length=train.num_queries)
            cv_tape.fold_evaluation(ranker, test_res, fold_k)
            if write_run_files:
                self._write_fold_run(ranker, test, test_qs, dir_run, fold_k)

        return cv_tape.get_cv_performance()

    def _write_fold_run(self, ranker, test_ds: DivBucketedDataset,
                        test_qs: Sequence[DivQuery], dir_run: str, fold_k: int,
                        need_per_q: bool = False):
        """fold_run.txt + qrels for the external ndeval oracle, using REAL
        docnos and DivBatch.qids for row attribution."""
        run_path = os.path.join(dir_run, f"fold_{fold_k}_run.txt")
        if os.path.exists(run_path):
            os.remove(run_path)
        topic_map = build_topic_map(test_qs)
        for batch in test_ds.batches():
            scores_all = ranker.predict(batch).cpu().numpy()
            for row in range(batch.doc_reprs.shape[0]):
                q = test_ds.query_for(batch, row)
                if q is None:
                    continue
                n = int(batch.doc_mask[row].sum())
                scores = scores_all[row]
                order = np.argsort(-scores[:n], kind="stable")
                docnos = (np.asarray(q.docnos)[order] if q.docnos is not None
                          else [f"doc{j}" for j in order])
                write_trec_run(run_path, topic_map[str(q.qid)], list(docnos),
                               scores[order].tolist())
        qrels_path = os.path.join(dir_run, f"fold_{fold_k}_qrels.txt")
        write_div_qrels(qrels_path, test_qs, topic_map)
        amean = self._ndeval_cross_check(qrels_path, run_path)
        per_q = (ranker.evaluate_per_query(test_ds.batches(), ks=(1, 3, 5, 10, 20))
                 if need_per_q else None)
        return amean, per_q

    @staticmethod
    def _ndeval_cross_check(qrels_path: str, run_path: str):
        """Run the native ndeval oracle (native/ndeval.cpp) over the emitted
        qrels and run, printing its amean row: the off-device cross-check of
        the on-device SRD metrics. None without a C++ toolchain; advisory, so
        a failed build or run prints a line and returns None."""
        try:
            if ndeval_binary() is None:
                return None
            amean = run_ndeval(qrels_path, run_path)["amean"]
        except (OSError, subprocess.SubprocessError, KeyError, ValueError) as exc:
            print(f" [ndeval oracle unavailable: {exc}]")
            return None
        keys = ("alpha-nDCG@5", "alpha-nDCG@10", "ERR-IA@5", "ERR-IA@10",
                "nERR-IA@5", "NRBP", "MAP-IA", "strec@10")
        print(" [ndeval] " + ", ".join(f"{k}:{amean[k]:.4f}" for k in keys))
        return amean

    # ------------------------------------------------------------ dispatch

    def set_settings(self, debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json):
        if dir_json:
            div_json = os.path.join(dir_json, "Div_Data_Eval_ScoringFunction.json")
            para_json = os.path.join(dir_json, f"{model_id}Parameter.json")
            self.data_setting = DivDataSetting(debug, data_json=div_json)
            self.eval_setting = DivEvalSetting(debug, eval_json=div_json)
            self.sf_setting = DivSFSetting(debug, sf_id=sf_id, sf_json=div_json)
            self.model_setting = DivModelSetting(model_id, debug, para_json=para_json)
        else:
            self.data_setting = DivDataSetting(debug, data_id=data_id, dir_data=dir_data)
            self.eval_setting = DivEvalSetting(debug, dir_output=dir_output)
            self.sf_setting = DivSFSetting(debug, sf_id=sf_id)
            self.model_setting = DivModelSetting(model_id, debug)

    def point_run(self, debug=False, model_id=None, sf_id="pointsf",
                  data_id=None, dir_data=None, dir_output="./div_output",
                  dir_json=None, epochs: Optional[int] = None,
                  model_paras: Optional[dict] = None, reproduce: bool = False,
                  write_run_files: bool = False, **eval_overrides):
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        data_dict = self.data_setting.default_setting()
        eval_dict = self.eval_setting.default_setting()
        if epochs is not None:
            eval_dict["epochs"] = epochs
        eval_dict.update(eval_overrides)
        sf_para = self.sf_setting.default_setting(data_dict["num_features"])
        mp = {"model_id": model_id, **self.model_setting.default_para_dict(),
              **(model_paras or {})}
        self.model_setting.para_dict.update(model_paras or {})
        return self.div_cv_eval(data_dict, eval_dict, sf_para, mp,
                                reproduce=reproduce, write_run_files=write_run_files)

    def grid_run(self, debug=False, model_id=None, sf_id="pointsf", data_id=None,
                 dir_data=None, dir_output="./div_output", dir_json=None):
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        best_value, best_cv = -np.inf, None
        for data_dict in self.data_setting.grid_search():
            for eval_dict in self.eval_setting.grid_search():
                for sf_para in self.sf_setting.grid_search(data_dict["num_features"]):
                    for mp in self.model_setting.grid_search():
                        mp = {"model_id": model_id, **mp}
                        cv = self.div_cv_eval(data_dict, eval_dict, sf_para, mp)
                        ks = list(eval_dict["cutoffs"])
                        k_idx = ks.index(eval_dict.get("vali_k") or 5) \
                            if (eval_dict.get("vali_k") or 5) in ks else 0
                        val = float(cv["aNDCG"][k_idx])
                        if val > best_value:
                            best_value, best_cv = val, cv
        return best_cv

    def run(self, debug=False, model_id=None, sf_id="pointsf", config_with_json=False,
            dir_json=None, data_id=None, dir_data=None, dir_output="./div_output",
            grid_search=False, reproduce=False):
        if model_id not in DIV_MODELS:
            raise ValueError(f"{model_id!r} not in {DIV_MODELS}")
        if config_with_json:
            if dir_json is None:
                raise ValueError("config_with_json needs dir_json")
            if reproduce:
                return self.point_run(debug, model_id, sf_id, dir_json=dir_json,
                                      reproduce=True)
            return self.grid_run(debug, model_id, sf_id, dir_json=dir_json)
        if grid_search:
            return self.grid_run(debug, model_id, sf_id, data_id, dir_data, dir_output)
        return self.point_run(debug, model_id, sf_id, data_id, dir_data, dir_output,
                              reproduce=reproduce)


def _with_noise(queries: List[DivQuery], seed: int, add_noise: bool = False,
                std_delta: float = 1.0) -> List[DivQuery]:
    """Additive Gaussian noise on representations (reference DIVDataset
    add_noise, div_data.py:78-93) for the synthetic path."""
    if not add_noise:
        return queries
    rng = np.random.RandomState(seed)
    out = []
    for q in queries:
        out.append(DivQuery(
            q.qid,
            q.q_repr + rng.normal(0, std_delta, q.q_repr.shape).astype(np.float32),
            q.doc_reprs + rng.normal(0, std_delta, q.doc_reprs.shape).astype(np.float32),
            q.rele_mat, q.docnos))
    return out


def _load_fold_yaml(path: str) -> Dict[str, list]:
    """Minimal yaml reader for the fold config {train:[...], vali:[...],
    test:[...]} (reference uses pyyaml, ltr_diversification.py:155-206).
    Accepts either yaml lists or a json file."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    out: Dict[str, list] = {}
    current = None
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.endswith(":"):
            current = stripped[:-1]
            out[current] = []
        elif stripped.startswith("- "):
            out[current].append(stripped[2:].strip())
        elif ":" in stripped:
            k, v = stripped.split(":", 1)
            out[k.strip()] = [x.strip() for x in v.strip(" []").split(",") if x.strip()]
    return out
