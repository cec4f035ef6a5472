"""AdhocRanker, inference half: init, predict and checkpoints.

Counterpart of ptranking_tpu/train/ranker.py for serving. A ranker holds a
scorer config and its params on one device; `predict` scores a padded batch.
Training methods come with the training slice; the model id is kept as a
string until the loss registry is ported.

Checkpoints:
  * the port's own `.pt` (torch.save of plain dicts, configs as dicts, params
    as CPU tensors), loadable with `torch.load(weights_only=True)`;
  * the JAX package's self-describing `.pkl`, read with a restricted
    unpickler that maps its config classes to the port's and its optax
    optimizer state to inert stubs, so reading it imports neither jax nor
    optax. The optimizer state is dropped.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ptranking_tpu_torch import LTR_SEED, resolve_device
from ptranking_tpu_torch.models.convert import params_from_jax
from ptranking_tpu_torch.models.scorers import (ScorerConfig, apply_scorer, init_scorer,
                                                map_params)
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.types import LabelType, RankingBatch

# Models whose loss needs the listwise scorer (ptranking_tpu/losses/__init__.py).
REQUIRES_LISTSF = ("DASALC",)

CHECKPOINT_FORMAT = "ptranking_tpu_torch/1"


class _Inert:
    """Stand-in for an optax/jax class in a JAX checkpoint: takes any
    constructor arguments and state, keeps nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


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
            return type(name, (_Inert,), {"__module__": module})
        if root == "numpy" and name in self.NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in a ranker checkpoint")


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of either package as one dict: model_id, scorer_cfg
    (ScorerConfig), model_paras, opt_cfg (OptimizerConfig), label_type
    (LabelType), params (numpy or tensor leaves), format ('torch' | 'jax')."""
    if zipfile.is_zipfile(path):  # torch.save writes a zip archive
        d = torch.load(path, map_location="cpu", weights_only=True)
        if d.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} checkpoint")
        cfg = dict(d["scorer_cfg"], ff_dims=tuple(d["scorer_cfg"]["ff_dims"]))
        return {"model_id": d["model_id"], "scorer_cfg": ScorerConfig(**cfg),
                "model_paras": d["model_paras"], "opt_cfg": OptimizerConfig(**d["opt_cfg"]),
                "label_type": LabelType[d["label_type"]], "params": d["params"],
                "format": "torch"}
    with open(path, "rb") as f:
        d = _JaxCheckpointUnpickler(f).load()
    if not isinstance(d, dict) or "scorer_cfg" not in d:
        raise ValueError(f"{path}: not a self-describing ranker checkpoint")
    return {"model_id": d["model_id"], "scorer_cfg": d["scorer_cfg"],
            "model_paras": d.get("model_paras") or {},
            "opt_cfg": d.get("opt_cfg") or OptimizerConfig(),
            "label_type": d.get("label_type", LabelType.MultiLabel),
            "params": d["params"], "format": "jax"}


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


class AdhocRanker:
    """A scorer config and its params on one device, for serving."""

    def __init__(self, model_id: str, scorer_cfg: ScorerConfig,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 label_type: LabelType = LabelType.MultiLabel,
                 seed: int = LTR_SEED, device="cuda"):
        if model_id in REQUIRES_LISTSF and not scorer_cfg.sf_id.startswith("listsf"):
            scorer_cfg = ScorerConfig.default_listsf(scorer_cfg.num_features)
        self.device = resolve_device(device)
        self.model_id = model_id
        self.scorer_cfg = scorer_cfg
        self.model_paras = dict(model_paras or {})
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.label_type = label_type
        self.seed = seed
        self.params = None

    def init(self) -> "AdhocRanker":
        """Fresh params from the seed."""
        self.params = init_scorer(self.scorer_cfg, self.seed, self.device)
        return self

    @torch.inference_mode()
    def predict(self, batch: RankingBatch) -> torch.Tensor:
        """Scores [B, N] (fp32, on the ranker's device) for a padded batch of
        numpy arrays or tensors."""
        if self.params is None:
            raise RuntimeError("init() or load() the ranker first")
        x = _to_device(batch.features, self.device)
        mask = _to_device(batch.mask, self.device, torch.bool)
        return apply_scorer(self.params, self.scorer_cfg, x, mask)

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
        }

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.checkpoint(), path)

    def restore(self, ckpt: Dict[str, Any]) -> "AdhocRanker":
        """Params from a checkpoint dict as `read_checkpoint` returns it."""
        if ckpt["model_id"] != self.model_id:
            raise ValueError(f"checkpoint is for {ckpt['model_id']!r}, "
                             f"this ranker is {self.model_id!r}")
        if ckpt["format"] == "jax":
            self.params = params_from_jax(ckpt["params"], self.scorer_cfg, self.device)
        else:
            self.params = map_params(lambda t: t.to(self.device), ckpt["params"])
        return self

    def load(self, path: str) -> "AdhocRanker":
        return self.restore(read_checkpoint(path))

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "AdhocRanker":
        """A ranker rebuilt from a self-describing checkpoint of either package."""
        d = read_checkpoint(path)
        ranker = cls(d["model_id"], d["scorer_cfg"], model_paras=d["model_paras"],
                     opt_cfg=d["opt_cfg"], label_type=d["label_type"], device=device)
        return ranker.restore(d)
