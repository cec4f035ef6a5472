"""Tape recorders: validation checkpointing, CV aggregation, epoch summaries.

The port's copy of ptranking_tpu/eval/tapes.py. The best checkpoint of a
fold is the port's own `.pt` (`AdhocRanker.save`); the summaries and the
reproduce-mode per-query matrices are pickled numpy arrays in the JAX
package's file layout. In a process group only rank 0 writes them
(parallel/collectives.py::is_writer).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import time
from typing import Dict, List, Optional

import numpy as np

from ptranking_tpu_torch.parallel.collectives import is_writer


class ValidationTape:
    """Tracks the best validation metric of a fold and saves its checkpoint
    (`net_params_epoch_<k>.pt`)."""

    def __init__(self, fold_k: int, num_epochs: int, validation_metric: str,
                 validation_k: int, dir_run: str):
        self.fold_k = fold_k
        self.num_epochs = num_epochs
        self.metric = validation_metric
        self.k = validation_k
        self.dir_fold = os.path.join(dir_run, f"Fold-{fold_k}") + os.sep
        if is_writer():
            os.makedirs(self.dir_fold, exist_ok=True)
        self.best_value = -np.inf
        self.best_epoch = 0

    def epoch_validation(self, epoch_k: int, metric_value: float, ranker) -> bool:
        if metric_value > self.best_value:
            self.best_value = metric_value
            self.best_epoch = epoch_k
            ranker.save(os.path.join(self.dir_fold, f"net_params_epoch_{epoch_k}.pt"))
            return True
        return False

    def get_optimal_path(self) -> str:
        return os.path.join(self.dir_fold, f"net_params_epoch_{self.best_epoch}.pt")

    def clear_fold_buffer(self):
        """Delete all but the optimal checkpoint."""
        if not is_writer():
            return
        keep = os.path.basename(self.get_optimal_path())
        for p in glob.glob(os.path.join(self.dir_fold, "net_params_epoch_*.pt")):
            if os.path.basename(p) != keep:
                os.remove(p)


def get_opt_model(dir_fold: str) -> Optional[str]:
    """The fold's checkpoint of the highest epoch (natural sort), or None."""
    paths = glob.glob(os.path.join(dir_fold, "net_params_epoch_*.pt"))
    if not paths:
        return None

    def key(p):
        m = re.search(r"epoch_(\d+)", p)
        return int(m.group(1)) if m else -1

    return max(paths, key=key)


class CVTape:
    """Aggregates the folds' test metrics into CV means."""

    METRICS = ("nDCG", "nERR", "AP", "P")

    def __init__(self, model_id: str, fold_num: int, cutoffs: List[int], do_validation: bool,
                 reproduce: bool = False, dir_run: str = None):
        self.model_id = model_id
        self.fold_num = fold_num
        self.cutoffs = list(cutoffs)
        self.do_validation = do_validation
        self.per_fold: Dict[str, List[np.ndarray]] = {m: [] for m in self.METRICS}
        self.reproduce = reproduce
        self.dir_run = dir_run
        self.per_query: Dict[str, List[np.ndarray]] = {m: [] for m in self.METRICS}
        self.t0 = time.time()

    def fold_evaluation(self, ranker, test_batches, fold_k: int):
        if self.reproduce:
            # per-query metric matrices, all folds concatenated
            if hasattr(test_batches, "batches"):
                test_batches = test_batches.batches()
            test_batches = list(test_batches)
            pq = ranker.evaluate_per_query(test_batches, ks=tuple(self.cutoffs))
            for m in self.METRICS:
                self.per_query[m].append(pq[m])
            out = {m: pq[m].mean(axis=0) for m in self.METRICS}
        else:
            out = ranker.evaluate(test_batches, ks=tuple(self.cutoffs))
        for m in self.METRICS:
            self.per_fold[m].append(np.asarray(out[m]))
        ndcg_str = ", ".join(f"nDCG@{k}:{v:.4f}" for k, v in zip(self.cutoffs, out["nDCG"]))
        print(f"\n Fold-{fold_k} {self.model_id} on test: {ndcg_str}")

    def get_cv_performance(self) -> Dict[str, np.ndarray]:
        if self.reproduce and self.dir_run and is_writer():
            names = {"P": "p", "AP": "ap", "nERR": "nerr", "nDCG": "ndcg"}
            for m, short in names.items():
                mat = np.concatenate(self.per_query[m], axis=0)
                path = os.path.join(
                    self.dir_run, f"{self.model_id}_all_fold_{short}_at_ks_per_q.np")
                with open(path, "wb") as f:
                    pickle.dump(mat, f, protocol=pickle.HIGHEST_PROTOCOL)
        elapsed = time.time() - self.t0
        means = {m: np.mean(np.stack(v), axis=0) for m, v in self.per_fold.items()}
        print(f"\n{self.model_id} {self.fold_num}-fold CV ({elapsed:.1f}s):")
        for m in self.METRICS:
            row = ", ".join(f"{m}@{k}:{v:.4f}" for k, v in zip(self.cutoffs, means[m]))
            print(" ", row)
        means["elapsed_s"] = np.asarray(elapsed)
        return means


class SummaryTape:
    """Per-epoch loss, train and test nDCG@ks tracks and the validation
    track, pickled per fold (`Fold_k_{train,test,vali}_eval.np` and
    `Fold_k_epoch_loss.np` = (epoch losses, train length))."""

    def __init__(self, do_validation: bool, dir_run: str, fold_k: int,
                 cutoffs: Optional[List[int]] = None, id_str: Optional[str] = None):
        self.do_validation = do_validation
        self.fold_k = fold_k
        self.dir_run = dir_run
        self.id_str = id_str  # an infix of the file names
        self.cutoffs = tuple(cutoffs or (1, 3, 5, 10, 20, 50))
        self.list_epoch_loss: List[float] = []
        self.list_fold_k_vali_track: List[float] = []
        self.list_fold_k_train_track: List[np.ndarray] = []
        self.list_fold_k_test_track: List[np.ndarray] = []

    def epoch_summary(self, epoch_loss: float, vali_value: Optional[float] = None,
                      ranker=None, train_data=None, test_data=None):
        """Record one epoch. With a ranker and train/test datasets, also
        track the epoch's nDCG@ks on them."""
        self.list_epoch_loss.append(float(epoch_loss))
        if vali_value is not None:
            self.list_fold_k_vali_track.append(float(vali_value))
        if ranker is not None and train_data is not None:
            tr = ranker.evaluate(train_data, ks=self.cutoffs)
            self.list_fold_k_train_track.append(np.asarray(tr["nDCG"]))
        if ranker is not None and test_data is not None:
            te = ranker.evaluate(test_data, ks=self.cutoffs)
            self.list_fold_k_test_track.append(np.asarray(te["nDCG"]))

    def fold_summary(self, train_data_length: Optional[int] = None):
        if not is_writer():
            return
        prefix = os.path.join(self.dir_run, f"Fold_{self.fold_k}")
        if self.id_str:
            prefix = "_".join([prefix, self.id_str])

        def save(obj, suffix):
            with open("_".join([prefix, suffix]), "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

        if self.do_validation and self.list_fold_k_vali_track:
            save(np.hstack(self.list_fold_k_vali_track), "vali_eval.np")
        if self.list_fold_k_train_track:
            save(np.vstack(self.list_fold_k_train_track), "train_eval.np")
        if self.list_fold_k_test_track:
            save(np.vstack(self.list_fold_k_test_track), "test_eval.np")
        save((np.asarray(self.list_epoch_loss), train_data_length), "epoch_loss.np")


class OptLossTape:
    """Loss-guided early stop: True after `patience` epochs without a lower loss."""

    def __init__(self):
        self.best_loss = np.inf
        self.stuck = 0

    def epoch_cmp_loss(self, epoch_loss: float, patience: int = 10) -> bool:
        if epoch_loss < self.best_loss - 1e-8:
            self.best_loss = epoch_loss
            self.stuck = 0
            return False
        self.stuck += 1
        return self.stuck >= patience
