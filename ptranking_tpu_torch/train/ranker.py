"""AdhocRanker: init, training, predict and checkpoints.

Counterpart of ptranking_tpu/train/ranker.py. A ranker holds a scorer config,
its fp32 params on one device, the optimizer and one torch.Generator for
dropout and the stochastic losses' draws, all seeded from `seed`.
`train_epoch` runs one optimizer step per batch, eagerly (the JAX package's
scan of K steps per dispatch has no counterpart yet); `train_epoch_resident`
does the same over a DeviceResidentDataset, each batch gathered on the
device from an index chunk of `scan_steps` batches, one small index copy a
chunk; `predict` scores a padded batch; `evaluate` gives dataset-level nDCG,
nERR, AP and P at each k, one batch at a time, with one host fetch at the
end.

Checkpoints:
  * the port's own `.pt` (torch.save of plain dicts, configs as dicts, params
    and optimizer state as CPU tensors, the generator's state), loadable with
    `torch.load(weights_only=True)`;
  * the JAX package's self-describing `.pkl`, read with a restricted
    unpickler that maps its config classes to the port's and its optax state
    to `JaxNamedTuple` stand-ins, so reading it imports neither jax nor
    optax. Its optimizer state carries over (`opt_state_from_jax`); its PRNG
    key cannot, so dropout restarts from the seed.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import zipfile
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import LTR_SEED, resolve_device
from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset, take_features
from ptranking_tpu_torch.losses import DEFAULT_PARAS, REQUIRES_LISTSF, STOCHASTIC, get_loss
from ptranking_tpu_torch.metrics.adhoc import evaluate_all_at_ks
from ptranking_tpu_torch.models.convert import JaxNamedTuple, opt_state_from_jax, params_from_jax
from ptranking_tpu_torch.models.quantize import is_quantized, quantize_scorer_params
from ptranking_tpu_torch.models.scorers import (ScorerConfig, apply_scorer, init_scorer,
                                                map_params, tree_leaves)
from ptranking_tpu_torch.train.optimizer import OptimizerConfig, epoch_lr, make_optimizer, set_lr
from ptranking_tpu_torch.types import LabelType, RankingBatch

CHECKPOINT_FORMAT = "ptranking_tpu_torch/1"
METRICS = ("nDCG", "nERR", "AP", "P")
# index rows a chunk of the resident evaluation (the JAX package's EVAL_CHUNK)
EVAL_CHUNK = 64


class _JaxCheckpointUnpickler(pickle.Unpickler):
    CLASSES = {
        ("ptranking_tpu.models.scorers", "ScorerConfig"): ScorerConfig,
        ("ptranking_tpu.train.optimizer", "OptimizerConfig"): OptimizerConfig,
        ("ptranking_tpu.types", "LabelType"): LabelType,
    }
    NUMPY_NAMES = {"dtype", "ndarray", "_reconstruct", "_frombuffer", "scalar"}

    def find_class(self, module, name):
        if (module, name) in self.CLASSES:
            return self.CLASSES[(module, name)]
        root = module.split(".")[0]
        if root in ("optax", "jax", "jaxlib"):
            return type(name, (JaxNamedTuple,), {"__module__": module})
        if root == "numpy" and name in self.NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in a ranker checkpoint")


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of either package as one dict: model_id, scorer_cfg
    (ScorerConfig), model_paras, opt_cfg (OptimizerConfig), label_type
    (LabelType), params (numpy or tensor leaves), format ('torch' | 'jax'),
    and the training state when the checkpoint has it: optimizer and
    generator (torch), opt_state (jax)."""
    if zipfile.is_zipfile(path):  # torch.save writes a zip archive
        d = torch.load(path, map_location="cpu", weights_only=True)
        if d.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} checkpoint")
        return torch_checkpoint(d)
    with open(path, "rb") as f:
        d = _JaxCheckpointUnpickler(f).load()
    if not isinstance(d, dict) or "scorer_cfg" not in d:
        raise ValueError(f"{path}: not a self-describing ranker checkpoint")
    return {"model_id": d["model_id"], "scorer_cfg": d["scorer_cfg"],
            "model_paras": d.get("model_paras") or {},
            "opt_cfg": d.get("opt_cfg") or OptimizerConfig(),
            "label_type": d.get("label_type", LabelType.MultiLabel),
            "params": d["params"], "opt_state": d.get("opt_state"), "format": "jax"}


def torch_checkpoint(d: Dict[str, Any]) -> Dict[str, Any]:
    """`read_checkpoint`'s dict from the dict that `AdhocRanker.checkpoint`
    returns (as `torch.load` gives it back)."""
    cfg = dict(d["scorer_cfg"], ff_dims=tuple(d["scorer_cfg"]["ff_dims"]))
    return {"model_id": d["model_id"], "scorer_cfg": ScorerConfig(**cfg),
            "model_paras": d["model_paras"], "opt_cfg": OptimizerConfig(**d["opt_cfg"]),
            "label_type": LabelType[d["label_type"]], "params": d["params"],
            "optimizer": d.get("optimizer"), "generator": d.get("generator"),
            "format": "torch"}


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


class AdhocRanker:
    """A scorer config, its params, a loss from the registry and an optimizer,
    on one device."""

    stop_check_freq = 10  # epochs between NaN/all-zero checks

    def __init__(self, model_id: str, scorer_cfg: ScorerConfig,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 label_type: LabelType = LabelType.MultiLabel,
                 seed: int = LTR_SEED, scan_steps: int = 32, device="cuda"):
        if model_id in REQUIRES_LISTSF and not scorer_cfg.sf_id.startswith("listsf"):
            scorer_cfg = ScorerConfig.default_listsf(scorer_cfg.num_features)
        self.device = resolve_device(device)
        # batches an index chunk of train_epoch_resident (one index copy a
        # chunk); it changes no value
        self.scan_steps = max(int(scan_steps), 1)
        self.model_id = model_id
        self.scorer_cfg = scorer_cfg
        # an id the registry lacks raises KeyError here, as in the reference
        self.loss_fn = get_loss(model_id)
        self.model_paras = {**DEFAULT_PARAS[model_id], **(model_paras or {})}
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.label_type = label_type
        self.seed = seed
        self.params = None
        self._optimizer = None
        self._gen = None

    def init(self) -> "AdhocRanker":
        """Fresh params, optimizer and dropout generator from the seed."""
        self.params = init_scorer(self.scorer_cfg, self.seed, self.device)
        self._start_training_state()
        return self

    def _start_training_state(self):
        """fp32 master params that take gradients, a fresh optimizer over them
        and the dropout generator on the ranker's device."""
        leaves = tree_leaves(self.params)
        for t in leaves:
            t.requires_grad_(True)
        self._optimizer = make_optimizer(self.opt_cfg, leaves)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)

    # ----------------------------------------------------------------- train

    def _step(self, features: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """One optimizer step on one batch already on the device; returns the
        batch's loss as a device tensor (no host sync)."""
        self._optimizer.zero_grad(set_to_none=True)
        scores = apply_scorer(self.params, self.scorer_cfg, features, mask,
                              training=True, gen=self._gen)
        # a stochastic loss draws from the same generator, after the scorer's dropout
        kw = {"gen": self._gen} if self.model_id in STOCHASTIC else {}
        loss = self.loss_fn(scores, labels, mask, label_type=self.label_type,
                            **self.model_paras, **kw)
        loss.backward()
        self._optimizer.step()
        return loss.detach()

    def train_epoch(self, batches: Iterable[RankingBatch], epoch_k: int = 1) -> Tuple[float, bool]:
        """One epoch; returns (mean loss per real query, stop_training).

        Sets the epoch's StepLR learning rate and takes one step per batch.
        Every `stop_check_freq` epochs (a check epoch) it first checks each
        batch, before that batch's step, for NaN or all-zero scores, and
        returns (nan, True) at the first that fails, as the JAX package's
        check epochs do; a check waits for the device. In other epochs the
        host waits for the device once, at the end."""
        self._check_trainable()
        set_lr(self._optimizer, epoch_lr(self.opt_cfg, epoch_k))
        check = epoch_k % self.stop_check_freq == 0
        losses, counts = [], []
        for batch in batches:
            if check and self.stop_training(batch):
                return float("nan"), True
            x = _to_device(batch.features, self.device)
            labels = _to_device(batch.labels, self.device, torch.float32)
            mask = _to_device(batch.mask, self.device, torch.bool)
            losses.append(self._step(x, labels, mask))
            counts.append(torch.sum(torch.any(mask, dim=-1)))
        if not losses:
            return 0.0, False
        total, num_queries = (float(t) for t in
                              torch.stack([torch.stack(losses).sum(),
                                           torch.stack(counts).sum().float()]).cpu())
        return total / max(num_queries, 1.0), False

    def train_epoch_resident(self, res: DeviceResidentDataset, epoch_k: int = 1,
                             shuffle: bool = True) -> Tuple[float, bool]:
        """One epoch over a DeviceResidentDataset; returns (loss summed over the
        epoch / res.num_queries, stop_training).

        Sets the epoch's learning rate, then walks the epoch's index chunks
        of `scan_steps` batches: one host->device copy of a chunk's [k, B]
        index array, each batch gathered on the device from the bucket
        arrays and stepped on its own. A check epoch first guards the first
        batch of its first chunk (NaN or all-zero scores give (nan, True)),
        as the JAX package does; the host waits for the device once, at the
        end, and a non-finite total gives (nan, True)."""
        self._check_trainable()
        set_lr(self._optimizer, epoch_lr(self.opt_cfg, epoch_k))
        checked = epoch_k % self.stop_check_freq != 0
        losses = []
        for bucket, idx_k, _ in res.epoch_index_chunks(shuffle, epoch_k, self.scan_steps):
            feats, labels, mask = res.bucket_arrays(bucket)
            idx_k = res.index_to_device(idx_k)
            if not checked:
                if self._scores_fail(take_features(feats, idx_k[0]),
                                     mask.index_select(0, idx_k[0])):
                    return float("nan"), True
                checked = True
            for idx in idx_k:
                losses.append(self._step(take_features(feats, idx), labels.index_select(0, idx),
                                         mask.index_select(0, idx)))
        total = float(torch.stack(losses).sum()) if losses else 0.0
        if not np.isfinite(total):
            return float("nan"), True
        return total / max(res.num_queries, 1), False

    def _check_trainable(self):
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")
        if is_quantized(self.params):
            raise RuntimeError(
                "this ranker holds int8-quantized inference params "
                "(AdhocRanker.quantized()); rounding has no gradient: train the "
                "original ranker instead")

    def quantized(self) -> "AdhocRanker":
        """An inference-only copy with per-channel int8 weights
        (models/quantize.py): every linear layer runs an int8 x int8 -> int32
        product (`torch._int_mm` on the card). predict and evaluate work
        unchanged; training the copy raises (rounding has no gradient), and
        its optimizer state is dropped to make that plain."""
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")
        r = copy.copy(self)
        # its own copy of the norms' params too: the original may train on
        r.params = quantize_scorer_params(map_params(lambda t: t.detach().clone(), self.params))
        r._optimizer = None
        return r

    def stop_training(self, batch: RankingBatch) -> bool:
        """NaN/all-zero prediction guard on one batch: True = training has failed."""
        return self._scores_fail(_to_device(batch.features, self.device),
                                 _to_device(batch.mask, self.device, torch.bool))

    @torch.inference_mode()
    def _scores_fail(self, x: torch.Tensor, mask: torch.Tensor) -> bool:
        masked = torch.where(mask, apply_scorer(self.params, self.scorer_cfg, x, mask), 0.0)
        return not bool(torch.isfinite(masked).all()) or not bool(torch.any(masked != 0.0))

    @torch.inference_mode()
    def predict(self, batch: RankingBatch) -> torch.Tensor:
        """Scores [B, N] (fp32, on the ranker's device) for a padded batch of
        numpy arrays or tensors."""
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")
        x = _to_device(batch.features, self.device)
        mask = _to_device(batch.mask, self.device, torch.bool)
        return apply_scorer(self.params, self.scorer_cfg, x, mask)

    # ------------------------------------------------------------------ eval

    @torch.inference_mode()
    def evaluate(self, batches, ks=(1, 3, 5, 10, 20, 50)) -> Dict[str, np.ndarray]:
        """Dataset-level metric means {nDCG, nERR, AP, P: [len(ks)]} over the
        real queries. `batches` is an iterable of padded batches or an object
        with `.batches()`. Batches are evaluated one at a time and never
        merged (BN uses batch statistics at eval); each leaves a packed
        [4 * len(ks) + 1] sum on the device, the real-query count in the last
        slot, and the host fetches their total once, at the end. A
        DeviceResidentDataset is evaluated from its index chunks
        (`_evaluate_resident`)."""
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")
        ks = tuple(ks)
        if isinstance(batches, DeviceResidentDataset):
            return self._evaluate_resident(batches, ks)
        if hasattr(batches, "batches"):
            batches = batches.batches()
        return self._reduce_packed_rows(
            [self._eval_sums(_to_device(b.features, self.device),
                             _to_device(b.labels, self.device, torch.float32),
                             _to_device(b.mask, self.device, torch.bool), ks)
             for b in batches], len(ks))

    def _evaluate_resident(self, res: DeviceResidentDataset, ks) -> Dict[str, np.ndarray]:
        """`evaluate` over a DeviceResidentDataset: index chunks of EVAL_CHUNK
        batches, one index copy a chunk, each batch gathered on the device
        and scored on its own."""
        packed_rows = []
        for bucket, idx_k, _ in res.epoch_index_chunks(False, 0, EVAL_CHUNK):
            feats, labels, mask = res.bucket_arrays(bucket)
            for idx in res.index_to_device(idx_k):
                packed_rows.append(self._eval_sums(take_features(feats, idx),
                                                   labels.index_select(0, idx),
                                                   mask.index_select(0, idx), ks))
        return self._reduce_packed_rows(packed_rows, len(ks))

    def _eval_sums(self, x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   ks) -> torch.Tensor:
        """One batch's packed [4 * len(ks) + 1] metric sums, on the device."""
        scores = apply_scorer(self.params, self.scorer_cfg, x, mask)
        out = evaluate_all_at_ks(scores, labels, mask, ks, self.label_type)
        # all-padded remainder rows add zero metric and must not count
        count = torch.sum(torch.any(mask, dim=-1)).to(torch.float32)
        return torch.cat([torch.sum(out[m], dim=0) for m in METRICS] + [count[None]])

    @staticmethod
    def _reduce_packed_rows(packed_rows, K: int, names=METRICS) -> Dict[str, np.ndarray]:
        """Metric means from packed [len(names) * K + 1] rows (the metrics'
        sums, then the real-query count): their sum fetched once. The
        diversification ranker shares it with its own metric names."""
        if not packed_rows:
            return {m: np.zeros(K) for m in names}
        total = torch.stack(packed_rows).sum(0).cpu().numpy()
        count = float(total[len(names) * K])
        if count == 0:
            return {m: np.zeros(K) for m in names}
        return {m: total[i * K:(i + 1) * K] / count for i, m in enumerate(names)}

    def validation(self, batches, k: int = 5, metric: str = "nDCG") -> float:
        """One validation scalar: `metric`@k over the batches."""
        return float(self.evaluate(batches, ks=(k,))[metric][0])

    @torch.inference_mode()
    def evaluate_per_query(self, batches: Iterable[RankingBatch],
                           ks=(1, 3, 5, 10, 20, 50)) -> Dict[str, np.ndarray]:
        """Per-query metric matrices [num_queries, len(ks)] for real queries."""
        ks = tuple(ks)
        rows: Dict[str, list] = {m: [] for m in METRICS}
        for batch in batches:
            labels = _to_device(batch.labels, self.device, torch.float32)
            mask = _to_device(batch.mask, self.device, torch.bool)
            out = evaluate_all_at_ks(self.predict(batch), labels, mask, ks, self.label_type)
            real = torch.any(mask, dim=-1)
            for m in rows:
                rows[m].append(out[m][real].cpu().numpy())
        return {m: (np.concatenate(v) if v else np.zeros((0, len(ks)))) for m, v in rows.items()}

    # ------------------------------------------------------------------- io

    def checkpoint(self) -> Dict[str, Any]:
        cfg = dataclasses.asdict(self.scorer_cfg)
        cfg["ff_dims"] = list(cfg["ff_dims"])
        return {
            "format": CHECKPOINT_FORMAT,
            "model_id": self.model_id,
            "scorer_cfg": cfg,
            "model_paras": self.model_paras,
            "opt_cfg": dataclasses.asdict(self.opt_cfg),
            "label_type": self.label_type.name,
            "params": map_params(lambda t: t.detach().cpu(), self.params),
            "optimizer": map_params(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                    self._optimizer.state_dict()),
            "generator": {"device": self.device.type, "state": self._gen.get_state()},
        }

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.checkpoint(), path)

    def restore(self, ckpt: Dict[str, Any]) -> "AdhocRanker":
        """Params, and the optimizer and generator state where the checkpoint
        has them, from a checkpoint dict as `read_checkpoint` returns it. A
        generator state saved on another device type is not restored: dropout
        then restarts from the seed."""
        if ckpt["model_id"] != self.model_id:
            raise ValueError(f"checkpoint is for {ckpt['model_id']!r}, "
                             f"this ranker is {self.model_id!r}")
        self.params = self._checkpoint_params(ckpt)
        self._start_training_state()
        opt_state = ckpt.get("optimizer")
        if ckpt.get("opt_state") is not None:
            jax_state = opt_state_from_jax(ckpt["opt_state"], self.scorer_cfg, self.opt_cfg.opt,
                                           self.device)
            opt_state = self._optimizer.state_dict()
            opt_state["state"] = jax_state["state"]
            for group in opt_state["param_groups"]:
                group["lr"] = jax_state["lr"]
        if opt_state is not None:
            self._optimizer.load_state_dict(opt_state)
        gen = ckpt.get("generator")
        if gen is not None and gen["device"] == self.device.type:
            self._gen.set_state(gen["state"])
        return self

    def _checkpoint_params(self, ckpt: Dict[str, Any]):
        """The params of a `read_checkpoint` dict on the ranker's device."""
        if ckpt["format"] == "jax":
            return params_from_jax(ckpt["params"], self.scorer_cfg, self.device)
        return map_params(lambda t: t.to(self.device), ckpt["params"])

    def load(self, path: str) -> "AdhocRanker":
        return self.restore(read_checkpoint(path))

    def load_params_only(self, path: str) -> "AdhocRanker":
        """The scorer weights alone from a checkpoint of either package (the
        port's `.pt` or the JAX package's `.pkl`); the optimizer state and
        the generator stay as they are. The weights are copied into the
        ranker's own tensors, which its optimizer holds."""
        new = self._checkpoint_params(read_checkpoint(path))
        if self.params is None:
            self.params = new
            self._start_training_state()
            return self
        dst, src = tree_leaves(self.params), tree_leaves(new)
        if len(dst) != len(src) or any(a.shape != b.shape for a, b in zip(dst, src)):
            raise ValueError(f"{path}: its params do not fit this ranker's scorer")
        with torch.no_grad():
            for a, b in zip(dst, src):
                a.copy_(b)
        return self

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "AdhocRanker":
        """A ranker rebuilt from a self-describing checkpoint of either package."""
        d = read_checkpoint(path)
        ranker = cls(d["model_id"], d["scorer_cfg"], model_paras=d["model_paras"],
                     opt_cfg=d["opt_cfg"], label_type=d["label_type"], device=device)
        return ranker.restore(d)
