"""DivRanker: training, prediction, evaluation and checkpoints of the
diversified ranking models (DALETOR, DivProbRanker).

The port's copy of ptranking_tpu/diversification/ranker.py, on one device,
or data-parallel over a mesh (`mesh=`): each rank takes its block of every
batch's rows and the gradients, loss totals and metric sums are summed over
the ranks, as in parallel/train.py.
The JAX package fuses `scan_steps` batches into one dispatch; the port steps
eagerly, one optimizer step a batch. `train_epoch` takes streamed batches
(mean loss over the real queries); `train_epoch_resident` walks a
DivDeviceResidentDataset's index chunks of `scan_steps` batches, one index
copy a chunk, each batch gathered on the device (mean over `num_queries`).
`evaluate` leaves one packed [3K + 1] row of sums a batch on the device
(aNDCG, ERR-IA, nERR-IA at each k, then the real-query count) and fetches
their total once.

Checkpoints are the port's own `.pt` (params, optimizer and generator
state); `load` also reads the JAX package's `.pkl` (params and the optax
state, through the adhoc ranker's restricted unpickler, which imports
neither jax nor optax).
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import LTR_SEED, PAD_SCORE, resolve_device
from ptranking_tpu_torch.data.device_cache import DivDeviceResidentDataset
from ptranking_tpu_torch.diversification.data import DivBatch
from ptranking_tpu_torch.diversification.losses import DIV_LOSSES
from ptranking_tpu_torch.diversification.scorers import (DivScorerConfig, div_forward,
                                                         div_predict, init_div_scorer)
from ptranking_tpu_torch.metrics.srd import alpha_ndcg_at_ks, err_ia_at_ks, nerr_ia_at_ks
from ptranking_tpu_torch.models.convert import div_params_from_jax, opt_state_from_jax
from ptranking_tpu_torch.models.scorers import map_params, tree_leaves
from ptranking_tpu_torch.parallel.mesh import data_parallel
from ptranking_tpu_torch.train.optimizer import (OptimizerConfig, epoch_lr, make_optimizer,
                                                 set_lr)
from ptranking_tpu_torch.train.ranker import (EVAL_CHUNK, AdhocRanker, _JaxCheckpointUnpickler,
                                              _to_device, open_binary)

DIV_MODELS = ["DALETOR", "DivProbRanker"]
DIV_METRICS = ("aNDCG", "ERR-IA", "nERR-IA")
DIV_CHECKPOINT_FORMAT = "ptranking_tpu_torch/div/1"
# model paras that configure the scorer's head or pick the loss, not the loss's own
_HEAD_PARAS = ("opt_id", "metric", "K", "cluster", "sort_id", "limit_delta")


def _sorted_rele(scores, rele_mat, dmask):
    """The coverage matrix and doc mask in the order of descending scores
    (stable; pads last)."""
    order = torch.argsort(-torch.where(dmask, scores, PAD_SCORE), dim=-1, stable=True)
    sys_rele = torch.gather(rele_mat, -1, order[:, None, :].expand(rele_mat.shape))
    return sys_rele, torch.gather(dmask, -1, order)


def _read_div_checkpoint(path) -> Dict[str, Any]:
    """The dict of a `.pt` of this package or a `.pkl` of the JAX package
    (`path` may be a binary file object)."""
    if zipfile.is_zipfile(path):
        with open_binary(path) as f:
            d = torch.load(f, map_location="cpu", weights_only=True)
        if d.get("format") != DIV_CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: not a {DIV_CHECKPOINT_FORMAT} checkpoint")
        return d
    with open_binary(path) as f:
        d = _JaxCheckpointUnpickler(f).load()
    if not isinstance(d, dict) or "params" not in d or "opt_state" not in d:
        raise ValueError(f"{path}: not a diversification ranker checkpoint")
    return d


class DivRanker:
    """A diversification scorer config, its params, a loss of DIV_LOSSES and
    an optimizer, on one device."""

    def __init__(self, model_id: str, scorer_cfg: DivScorerConfig,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None, seed: int = LTR_SEED,
                 scan_steps: int = 8, mesh=None, device="cuda"):
        if model_id not in DIV_MODELS:
            raise ValueError(f"{model_id!r} not in {DIV_MODELS}")
        self._dp = data_parallel(mesh)
        self.device = resolve_device(device)
        # batches an index chunk of train_epoch_resident; it changes no value
        self.scan_steps = max(int(scan_steps), 1)
        self.model_id = model_id
        self.scorer_cfg = scorer_cfg
        self.model_paras = dict(model_paras or {})
        self.opt_cfg = opt_cfg or OptimizerConfig(opt="Adam", lr=1e-3)
        self.seed = seed
        if model_id == "DALETOR":
            self._loss_key = "DALETOR"
        else:
            opt_id = self.model_paras.get("opt_id", "SuperSoft")
            if opt_id == "SuperSoft":
                self._loss_key = f"SuperSoft-{self.model_paras.get('metric', 'aNDCG')}"
            else:
                self._loss_key = opt_id
        self.loss_fn = DIV_LOSSES[self._loss_key]
        self._loss_paras = {k: v for k, v in self.model_paras.items() if k not in _HEAD_PARAS}
        if self._loss_key in ("PairCLS", "LambdaPairCLS"):
            self._loss_paras["opt_id"] = self._loss_key
        self.params = None
        self._optimizer = None
        self._gen = None

    def init(self) -> "DivRanker":
        """Fresh params, optimizer and dropout generator from the seed."""
        self.params = init_div_scorer(self.scorer_cfg, self.seed, self.device)
        self._start_training_state()
        self._dp.broadcast(self._leaves)
        return self

    def _start_training_state(self):
        leaves = tree_leaves(self.params)
        for t in leaves:
            t.requires_grad_(True)
        self._leaves = leaves
        self._optimizer = make_optimizer(self.opt_cfg, leaves)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _check_ready(self):
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")

    # ----------------------------------------------------------------- train

    def _loss(self, q, d, rm, dm) -> torch.Tensor:
        mus, vars_, cocos = div_forward(self.params, self.scorer_cfg, q, d, dm,
                                        training=True, gen=self._gen)
        if self.model_id == "DALETOR":
            return self.loss_fn(mus, rm, dm, **self._loss_paras)
        return self.loss_fn(mus, vars_, rm, dm, cocos=cocos, **self._loss_paras)

    def _step(self, q: torch.Tensor, d: torch.Tensor, rm: torch.Tensor,
              dm: torch.Tensor) -> torch.Tensor:
        """One optimizer step on one batch already on the device; returns the
        batch's loss as a device tensor (no host sync)."""
        self._optimizer.zero_grad(set_to_none=True)
        with self._dp.rows(q.shape[0]):
            loss = self._loss(q, d, rm, dm)
            loss.backward()
        self._dp.reduce_grads(self._leaves)
        self._optimizer.step()
        return loss.detach()

    def _batch_arrays(self, b: DivBatch):
        """(q_repr, doc_reprs, rele_mat, doc_mask, subtopic_mask) on the
        device: this rank's block of the batch's rows under data
        parallelism."""
        dp, dev = self._dp, self.device
        return (_to_device(dp.shard(b.q_repr), dev), _to_device(dp.shard(b.doc_reprs), dev),
                _to_device(dp.shard(b.rele_mat), dev),
                _to_device(dp.shard(b.doc_mask), dev, torch.bool),
                _to_device(dp.shard(b.subtopic_mask), dev, torch.bool))

    def train_epoch(self, batches: Iterable[DivBatch], epoch_k: int = 1) -> Tuple[float, bool]:
        """One epoch of streamed batches; returns (loss summed over the epoch
        / real queries, stop_training). The host waits for the device once,
        at the end; a non-finite total gives (nan, True)."""
        self._check_ready()
        set_lr(self._optimizer, epoch_lr(self.opt_cfg, epoch_k))
        losses, counts = [], []
        for b in batches:
            q, d, rm, dm, _ = self._batch_arrays(b)
            losses.append(self._step(q, d, rm, dm))
            counts.append(torch.sum(torch.any(dm, dim=-1)))
        if not losses:
            return 0.0, False
        total, n = (float(t) for t in self._dp.all_reduce(
            torch.stack([torch.stack(losses).sum(), torch.stack(counts).sum().float()])).cpu())
        if not np.isfinite(total):
            return float("nan"), True
        return total / max(n, 1.0), False

    def train_epoch_resident(self, res: DivDeviceResidentDataset, epoch_k: int = 1,
                             shuffle: bool = True) -> Tuple[float, bool]:
        """One epoch over a DivDeviceResidentDataset; returns (loss summed over
        the epoch / res.num_queries, stop_training). One host->device copy of
        each chunk's [k, B] index array; each batch gathered on the device.
        The host waits once, at the end."""
        self._check_ready()
        set_lr(self._optimizer, epoch_lr(self.opt_cfg, epoch_k))
        losses = []
        for bucket, idx_k, _ in res.epoch_index_chunks(shuffle, epoch_k, self.scan_steps):
            q, d, rm, dm, _sm = res.bucket_arrays(bucket)
            idx_k = self._dp.shard_index(idx_k, q.shape[0] - 1)
            for idx in res.index_to_device(idx_k):
                losses.append(self._step(q.index_select(0, idx), d.index_select(0, idx),
                                         rm.index_select(0, idx), dm.index_select(0, idx)))
        total = float(self._dp.all_reduce(torch.stack(losses).sum())) if losses else 0.0
        if not np.isfinite(total):
            return float("nan"), True
        return total / max(res.num_queries, 1), False

    # ------------------------------------------------------------- predict

    @torch.inference_mode()
    def predict(self, batch: DivBatch) -> torch.Tensor:
        """Sorting scores [B, N] (on the ranker's device) of a padded batch of
        numpy arrays or tensors, by the config's sort_id."""
        self._check_ready()
        dp, dev = self._dp, self.device
        q, d = _to_device(dp.shard(batch.q_repr), dev), _to_device(dp.shard(batch.doc_reprs), dev)
        dm = _to_device(dp.shard(batch.doc_mask), dev, torch.bool)
        with dp.rows(q.shape[0]):
            scores = div_predict(self.params, self.scorer_cfg, q, d, dm)
        return dp.gather_rows(scores)[:batch.doc_mask.shape[0]]

    def _eval_sums(self, q, d, rm, dm, sm, ks) -> torch.Tensor:
        """One batch's packed [3 * len(ks) + 1] metric sums, on the device."""
        with self._dp.rows(q.shape[0]):
            scores = div_predict(self.params, self.scorer_cfg, q, d, dm)
        sys_rele, sys_mask = _sorted_rele(scores, rm, dm)
        # rm arrives in ideal (presorted) order
        andcg = alpha_ndcg_at_ks(sys_rele, rm, sys_mask, ks)
        err_ia = err_ia_at_ks(sys_rele, sys_mask, 1.0, ks, subtopic_mask=sm)
        nerr_ia = nerr_ia_at_ks(sys_rele, rm, sys_mask, 1.0, ks, subtopic_mask=sm)
        count = torch.sum(torch.any(dm, dim=-1)).to(torch.float32)
        return torch.cat([torch.sum(andcg, 0), torch.sum(err_ia, 0), torch.sum(nerr_ia, 0),
                          count[None]])

    @torch.inference_mode()
    def evaluate(self, batches, ks=(1, 3, 5, 10, 20)) -> Dict[str, np.ndarray]:
        """Dataset-level means {aNDCG, ERR-IA, nERR-IA: [len(ks)]} over the
        real queries. `batches` is an iterable of DivBatch or an object with
        `.batches()`; a DivDeviceResidentDataset is evaluated from its index
        chunks of EVAL_CHUNK batches, each gathered on the device. Batches
        are scored one at a time (BN takes batch statistics)."""
        self._check_ready()
        ks = tuple(ks)
        rows = []
        if isinstance(batches, DivDeviceResidentDataset):
            for bucket, idx_k, _ in batches.epoch_index_chunks(False, 0, EVAL_CHUNK):
                arrays = batches.bucket_arrays(bucket)
                idx_k = self._dp.shard_index(idx_k, arrays[0].shape[0] - 1)
                for idx in batches.index_to_device(idx_k):
                    rows.append(self._eval_sums(*(a.index_select(0, idx) for a in arrays), ks))
            return AdhocRanker._reduce_packed_rows(rows, len(ks), names=DIV_METRICS, dp=self._dp)
        if hasattr(batches, "batches"):
            batches = batches.batches()
        for b in batches:
            rows.append(self._eval_sums(*self._batch_arrays(b), ks))
        return AdhocRanker._reduce_packed_rows(rows, len(ks), names=DIV_METRICS, dp=self._dp)

    def validation(self, batches, k: int = 5, metric: str = "aNDCG") -> float:
        return float(self.evaluate(batches, ks=(k,))[metric][0])

    @torch.inference_mode()
    def evaluate_per_query(self, batches: Iterable[DivBatch],
                           ks=(1, 3, 5, 10, 20)) -> np.ndarray:
        """Per-query aNDCG@ks [num_real_queries, len(ks)]."""
        ks = tuple(ks)
        rows = []
        dp = self._dp
        for b in batches:
            q, d, rm, dm, _ = self._batch_arrays(b)
            with dp.rows(q.shape[0]):
                scores = div_predict(self.params, self.scorer_cfg, q, d, dm)
            sys_rele, sys_mask = _sorted_rele(scores, rm, dm)
            per_q = alpha_ndcg_at_ks(sys_rele, rm, sys_mask, ks)
            # every rank's rows, in order: the padded global batch
            real = dp.gather_rows(torch.any(dm, dim=-1))
            rows.append(dp.gather_rows(per_q)[real].cpu().numpy())
        return np.concatenate(rows, axis=0) if rows else np.zeros((0, len(ks)))

    # ------------------------------------------------------------------- io

    def checkpoint(self) -> Dict[str, Any]:
        self._check_ready()
        cfg = dataclasses.asdict(self.scorer_cfg)
        cfg["ff_dims"] = list(cfg["ff_dims"])
        return {
            "format": DIV_CHECKPOINT_FORMAT,
            "model_id": self.model_id,
            "scorer_cfg": cfg,
            "model_paras": self.model_paras,
            "opt_cfg": dataclasses.asdict(self.opt_cfg),
            "params": map_params(lambda t: t.detach().cpu(), self.params),
            "optimizer": map_params(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                    self._optimizer.state_dict()),
            "generator": {"device": self.device.type, "state": self._gen.get_state()},
        }

    def save(self, path: str):
        """The checkpoint to `path`; under data parallelism rank 0 writes it
        and every rank waits for the file."""
        if self._dp.is_writer:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            torch.save(self.checkpoint(), path)
        self._dp.barrier()

    def load(self, path: str) -> "DivRanker":
        """Params and optimizer state from this package's `.pt` (and its
        generator state, when saved on this device type) or from the JAX
        package's `.pkl` (its PRNG key cannot carry over: dropout restarts
        from the seed). The checkpoint must be of this model id and fit this
        ranker's scorer config. Under data parallelism rank 0 reads the file
        and hands it to every rank."""
        d = _read_div_checkpoint(self._dp.fetch(path))
        if d.get("model_id") != self.model_id:
            raise ValueError(f"checkpoint is for {d.get('model_id')!r}, "
                             f"this ranker is {self.model_id!r}")
        if "format" in d:
            self.params = div_params_from_jax(
                map_params(lambda t: t.numpy(), d["params"]), self.scorer_cfg, self.device)
            self._start_training_state()
            self._optimizer.load_state_dict(d["optimizer"])
            if d["generator"]["device"] == self.device.type:
                self._gen.set_state(d["generator"]["state"])
            return self
        self.params = div_params_from_jax(d["params"], self.scorer_cfg, self.device)
        self._start_training_state()
        jax_state = opt_state_from_jax(d["opt_state"], self.scorer_cfg, self.opt_cfg.opt,
                                       self.device,
                                       ref=init_div_scorer(self.scorer_cfg, device="meta"))
        opt_state = self._optimizer.state_dict()
        opt_state["state"] = jax_state["state"]
        for group in opt_state["param_groups"]:
            group["lr"] = jax_state["lr"]
        self._optimizer.load_state_dict(opt_state)
        return self
