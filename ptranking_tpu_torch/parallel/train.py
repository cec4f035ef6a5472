"""DistributedTrainer: data-, tensor- and pipeline-parallel training and
evaluation over a mesh.

The port's counterpart of ptranking_tpu/parallel/train.py. One process a
device. Data parallelism (DP): every rank takes the block of each batch's
rows of its `data` coordinate (padded to a multiple of the DP degree with
all-masked rows) and runs the AdhocRanker's eager step on it; the ranks
along `model` see the same rows. What XLA inserts from the JAX package's
shardings is explicit here (parallel/collectives.py): the gradients are
summed over the `data` axis (every loss is a sum over queries, RankMSE's
denominator and BN's statistics span the ranks), and so are the loss
totals, the metric sums and the stop guard's counts, so every rank takes
the same decisions. Dropout and the stochastic losses draw for the global
batch from the same generator on every rank. Resident data is replicated
on every rank; each rank gathers its columns of an index chunk, one index
copy a chunk.

tp=True (TP): the params are made from the same seed on every rank and
each rank keeps its shards by mesh.py::scorer_param_sharding over the
`model` axis (head-split MHSA, column / row FFN layers); the scorer runs
them with the `model` collectives of parallel/tensor.py, and the optimizer
holds moments shaped like the shards (every optimizer here is elementwise).

pp_stages=k (PP): predict and the evaluations run the listsf encoder as a
k-stage GPipe pipeline over `model` (parallel/pipeline.py); training stays
data parallel, with whole params on every model rank, as in the JAX
package.

Checkpoints hold full tensors, interchangeable with the AdhocRanker's and
the JAX package's: every rank joins the shards (a collective), then rank 0
writes; rank 0 reads a checkpoint for every rank, and each keeps its
shards. `shard_docs` and a `seq` axis > 1 wait for ROADMAP queue A item 8c.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import LTR_SEED
from ptranking_tpu_torch.models.scorers import (ScorerConfig, init_scorer, map_params,
                                                tree_leaves)
from ptranking_tpu_torch.parallel.mesh import (axis_size, data_parallel, mesh_from_dict,
                                               model_parallel, scorer_param_sharding)
from ptranking_tpu_torch.parallel.pipeline import PPPlan
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker
from ptranking_tpu_torch.types import LabelType, RankingBatch


def refuse_unported(shard_docs: bool = False):
    """The setting of the slice still to come, named by its item."""
    if shard_docs:
        raise NotImplementedError("shard_docs (context parallelism over the `seq` axis) is "
                                  "not ported yet (ROADMAP queue A item 8c)")


class DistributedTrainer(AdhocRanker):
    """Mesh-parallel counterpart of AdhocRanker: DP over the batch axes,
    with tp=True the scorer's weights split over `model`, with pp_stages=k
    the encoder staged over `model` at inference."""

    def __init__(self, model_id: str, scorer_cfg: ScorerConfig, mesh,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 label_type: LabelType = LabelType.MultiLabel,
                 tp: bool = False, shard_docs: bool = False, cp_impl: str = "ring",
                 pp_stages: int = 0, scan_steps: int = 32, eval_chunk: Optional[int] = None,
                 seed: int = LTR_SEED, device="cuda"):
        refuse_unported(shard_docs)
        if cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"cp_impl must be 'ring' or 'ulysses', got {cp_impl!r}")
        if isinstance(mesh, dict):
            mesh = mesh_from_dict(mesh)
        pp_stages = int(pp_stages or 0)
        if pp_stages:  # the JAX package's assertions
            if tp:
                raise ValueError("pp_stages and tp both claim the `model` axis")
            if not scorer_cfg.sf_id.startswith("listsf"):
                raise ValueError("pp_stages stages the listsf encoder stack")
            if pp_stages != axis_size(mesh, "model"):
                raise ValueError(f"pp_stages={pp_stages} must equal the mesh's model axis "
                                 f"({axis_size(mesh, 'model')}): stages live on `model`")
            if scorer_cfg.encoder_layers % pp_stages:
                raise ValueError(f"{scorer_cfg.encoder_layers} encoder layers do not divide "
                                 f"into {pp_stages} stages")
        super().__init__(model_id, scorer_cfg, model_paras=model_paras, opt_cfg=opt_cfg,
                         label_type=label_type, seed=seed, scan_steps=scan_steps,
                         device=device)
        if eval_chunk is not None:
            self.eval_chunk = max(int(eval_chunk), 1)
        self.mesh = mesh
        self.tp = bool(tp)
        self.pp_stages = pp_stages
        self.cp_impl = cp_impl
        self._dp = data_parallel(mesh)
        self._pp = PPPlan(mesh) if pp_stages else None

    # ------------------------------------------------------------ shards

    def _shard(self, full):
        """This rank's params from a full params tree (under tp, its shards
        by scorer_param_sharding; the share's spec is set here)."""
        if not self.tp:
            return full
        self._tp = model_parallel(self.mesh, scorer_param_sharding(self.mesh, full,
                                                                   self.scorer_cfg.n_heads))
        return self._tp.shard(full)

    def init(self) -> "DistributedTrainer":
        """Fresh params from the seed (rank 0's on every rank), this rank's
        shards of them, the optimizer over the shards and the generator."""
        full = init_scorer(self.scorer_cfg, self.seed, self.device)
        self._dp.broadcast(tree_leaves(full))
        self.params = self._shard(full)
        self._start_training_state()
        return self

    def _checkpoint_params(self, ckpt: Dict[str, Any]):
        return self._shard(super()._checkpoint_params(ckpt))

    def _load_optimizer(self, opt_state):
        """A full optimizer state (a checkpoint's) cut like the params: each
        per-parameter tensor of a split leaf becomes the rank's block."""
        if self._tp is not None:
            splits = tree_leaves(self._tp.spec)
            opt_state = dict(opt_state, state={
                i: {k: (self._tp.shard_leaf(v, splits[i])
                        if isinstance(v, torch.Tensor) and v.dim() else v)
                    for k, v in st.items()}
                for i, st in opt_state["state"].items()})
        super()._load_optimizer(opt_state)

    def full_params(self):
        """The full params (detached, on the device): under tp the shards
        joined over `model`, a collective every rank calls."""
        params = map_params(lambda t: t.detach(), self.params)
        return params if self._tp is None else self._tp.join(params)

    def checkpoint(self) -> Dict[str, Any]:
        """AdhocRanker.checkpoint with full tensors: under tp every rank
        joins the params' and the optimizer moments' shards (collectives),
        so call it on every rank."""
        ck = super().checkpoint()
        if self._tp is None or self._tp.degree == 1:
            return ck
        splits = tree_leaves(self._tp.spec)
        ck["params"] = map_params(lambda t: t.cpu(), self.full_params())
        state = self._optimizer.state_dict()  # its per-param dicts are the live state's
        state["state"] = {i: {k: (self._tp.join_leaf(v, splits[i])
                                  if isinstance(v, torch.Tensor) and v.dim() else v)
                              for k, v in st.items()}
                          for i, st in state["state"].items()}
        ck["optimizer"] = map_params(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                     state)
        return ck

    # ------------------------------------------------------------- train

    def train_step(self, batch: RankingBatch) -> float:
        """One optimizer step on a padded batch; returns the global batch's
        loss (the host waits for it)."""
        self._check_trainable()
        return float(self._dp.all_reduce(self._step(*self._batch_arrays(batch))))

    def train_epoch(self, batches: Iterable[RankingBatch], epoch_k: int = 1) -> Tuple[float, bool]:
        """AdhocRanker.train_epoch; a non-finite epoch loss also stops
        training, as in the JAX package's DistributedTrainer."""
        loss, stop = super().train_epoch(batches, epoch_k)
        if not np.isfinite(loss):
            return float("nan"), True
        return loss, stop
