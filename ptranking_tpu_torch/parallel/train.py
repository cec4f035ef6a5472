"""DistributedTrainer: data-parallel training and evaluation over a mesh.

The port's counterpart of ptranking_tpu/parallel/train.py, DP only. One
process a device: every rank holds the same params and optimizer state
(made from the same seed on every rank, then broadcast from rank 0), takes
its contiguous block of each batch's rows (padded to a multiple of the DP
degree with all-masked rows) and runs the AdhocRanker's eager step on it.
What XLA inserts from the JAX package's shardings is explicit here
(parallel/collectives.py): the gradients are summed over the ranks (every
loss is a sum over queries, RankMSE's denominator and BN's statistics span
the ranks), and so are the loss totals, the metric sums and the stop
guard's counts, so every rank takes the same decisions. Dropout and the
stochastic losses draw for the global batch from the same generator on
every rank. Resident data is replicated on every rank; each rank gathers
its columns of an index chunk, one index copy a chunk. Checkpoints are the
AdhocRanker's: rank 0 writes them, rank 0 reads them for every rank.

Tensor parallelism and pipeline stages (`tp`, `pp_stages`, a `model` axis
> 1) wait for ROADMAP queue A item 8b; `shard_docs` and a `seq` axis > 1
for item 8c.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from ptranking_tpu_torch import LTR_SEED
from ptranking_tpu_torch.models.scorers import ScorerConfig
from ptranking_tpu_torch.parallel.mesh import data_parallel
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker
from ptranking_tpu_torch.types import LabelType, RankingBatch


def refuse_unported(tp: bool = False, shard_docs: bool = False, pp_stages: int = 0):
    """The settings of the slices still to come, named by their item."""
    if tp:
        raise NotImplementedError("tp (tensor parallelism over the `model` axis) is not "
                                  "ported yet (ROADMAP queue A item 8b)")
    if pp_stages:
        raise NotImplementedError("pp_stages (pipeline stages over the `model` axis) is not "
                                  "ported yet (ROADMAP queue A item 8b)")
    if shard_docs:
        raise NotImplementedError("shard_docs (context parallelism over the `seq` axis) is "
                                  "not ported yet (ROADMAP queue A item 8c)")


class DistributedTrainer(AdhocRanker):
    """Data-parallel counterpart of AdhocRanker over a mesh's batch axes."""

    def __init__(self, model_id: str, scorer_cfg: ScorerConfig, mesh,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 label_type: LabelType = LabelType.MultiLabel,
                 tp: bool = False, shard_docs: bool = False, cp_impl: str = "ring",
                 pp_stages: int = 0, scan_steps: int = 32, eval_chunk: Optional[int] = None,
                 seed: int = LTR_SEED, device="cuda"):
        refuse_unported(tp, shard_docs, int(pp_stages or 0))
        if cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"cp_impl must be 'ring' or 'ulysses', got {cp_impl!r}")
        super().__init__(model_id, scorer_cfg, model_paras=model_paras, opt_cfg=opt_cfg,
                         label_type=label_type, seed=seed, scan_steps=scan_steps,
                         device=device)
        if eval_chunk is not None:
            self.eval_chunk = max(int(eval_chunk), 1)
        self.mesh = mesh
        self.cp_impl = cp_impl
        self._dp = data_parallel(mesh)

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
