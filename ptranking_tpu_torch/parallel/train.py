"""DistributedTrainer: data-, tensor-, pipeline- and context-parallel
training and evaluation over a mesh.

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

shard_docs=True (CP): each rank takes its block of every list's docs as
well (its `seq` coordinate; N padded to a multiple of S with all-masked
docs, as the JAX trainer's `_mesh_pad`), and the scorer runs on it: the
listsf's attention through ring or Ulysses attention (`cp_impl`,
parallel/ring.py), BN's statistics over every rank's docs, dropout drawn
for the global batch and cut to the block. The O(N^2) losses of
CP_PAIR_LOSSES run on the blocks through the ring losses and the doc-sharded
WassRank (parallel/ring.py, parallel/ot.py), with the JAX trainer's routing
(`_cp_pair_loss`); every other loss runs on the scores gathered along
`seq`, whole rows alike on every `seq` rank. A rank's loss is its data
line's; the gradients sum over the gradient group (`data` x `seq`), the
loss totals, metric sums and counts over the batch axes only. predict,
evaluate, evaluate_per_query and the stop guard gather the scores along
`seq` before the metrics. With pp_stages too, inference takes the
pipeline on whole docs and training CP, as in the JAX package.

Checkpoints hold full tensors, interchangeable with the AdhocRanker's and
the JAX package's: every rank joins the shards (a collective), then rank 0
writes; rank 0 reads a checkpoint for every rank, and each keeps its
shards. Params are whole on every `seq` rank.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import EPSILON, LTR_SEED
from ptranking_tpu_torch.losses import STOCHASTIC
from ptranking_tpu_torch.models.scorers import (ScorerConfig, init_scorer, map_params,
                                                tree_leaves)
from ptranking_tpu_torch.parallel.collectives import _pad_rows
from ptranking_tpu_torch.parallel.mesh import (axis_size, cp_plan, data_parallel,
                                               mesh_from_dict, model_parallel,
                                               scorer_param_sharding)
from ptranking_tpu_torch.parallel.pipeline import PPPlan
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker
from ptranking_tpu_torch.types import LabelType, RankingBatch


class DistributedTrainer(AdhocRanker):
    """Mesh-parallel counterpart of AdhocRanker: DP over the batch axes,
    with tp=True the scorer's weights split over `model`, with pp_stages=k
    the encoder staged over `model` at inference, with shard_docs=True the
    docs split over `seq`."""

    # the model ids whose [B, N, N] pair space runs through a ring loss or
    # the doc-sharded Sinkhorn under shard_docs: every O(N^2) loss of the zoo
    CP_PAIR_LOSSES = ("LambdaRank", "RankNet", "LambdaLoss", "ApproxNDCG", "SoftRank",
                      "WassRank", "NeuralNDCG")

    def __init__(self, model_id: str, scorer_cfg: ScorerConfig, mesh,
                 model_paras: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 label_type: LabelType = LabelType.MultiLabel,
                 tp: bool = False, shard_docs: bool = False, cp_impl: str = "ring",
                 pp_stages: int = 0, scan_steps: int = 32, eval_chunk: Optional[int] = None,
                 seed: int = LTR_SEED, device="cuda"):
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
        self.shard_docs = bool(shard_docs)
        self._dp = data_parallel(mesh, self.shard_docs)
        self._pp = PPPlan(mesh) if pp_stages else None
        self._cp = cp_plan(mesh, cp_impl) if self.shard_docs else None

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

    # --------------------------------------------------------------- CP

    def _step(self, features: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """AdhocRanker._step; under shard_docs on the rank's block of the
        docs of its rows (features, labels and mask hold the rows' N docs):
        returns its data line's loss."""
        if self._cp is None:
            return super()._step(features, labels, mask)
        seq = self._cp.seq
        x, m = seq.block(features, 1), seq.block(mask, 1, False)
        self._optimizer.zero_grad(set_to_none=True)
        with self._dp.rows(x.shape[0], docs=mask.shape[1]):
            loss = self._cp_loss(self._scores(x, m, training=True, cp=self._cp), labels, mask)
            loss.backward()
        self._dp.reduce_grads(self._leaves)
        self._optimizer.step()
        return loss.detach()

    def _infer(self, x: torch.Tensor, mask: torch.Tensor, *rest: torch.Tensor):
        """AdhocRanker._infer; under shard_docs the scorer runs on the
        rank's block of the docs and the scores are gathered along `seq`
        (a pipeline, pp_stages, takes whole docs instead)."""
        if self._cp is None or self._pp is not None:
            return super()._infer(x, mask, *rest)
        seq, N = self._cp.seq, mask.shape[1]
        with self._dp.rows(x.shape[0], docs=N):
            scores = self._scores(seq.block(x, 1), seq.block(mask, 1, False), cp=self._cp)
        return (seq.gather(scores, 1)[:, :N], mask, *rest)

    def _cp_loss(self, scores: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """The data line's loss from the rank's block of scores [B, n] and the
        rows' whole labels and mask [B, N]. CP_PAIR_LOSSES route as in the
        JAX trainer (`_cp_pair_loss`); every other loss runs on the scores
        gathered along `seq` (its backward: the rank's block), in a scope
        of rows alone: its draws and counts are those of whole rows."""
        cp, paras, lt = self._cp, self.model_paras, self.label_type
        seq, model_id, N = cp.seq, self.model_id, mask.shape[1]
        if model_id not in self.CP_PAIR_LOSSES:
            with self._dp.rows(scores.shape[0]):
                kw = {"gen": self._gen} if model_id in STOCHASTIC else {}
                return self.loss_fn(seq.gather(scores, 1)[:, :N], labels, mask, label_type=lt,
                                    **paras, **kw)
        from ptranking_tpu_torch.losses.listwise import _full_dcg
        from ptranking_tpu_torch.ops import gain, sort_labels_by_scores
        from ptranking_tpu_torch.parallel.ot import cp_wass_rank
        from ptranking_tpu_torch.parallel.ring import (ring_approx_ndcg, ring_lambda_loss,
                                                       ring_lambdaloss, ring_neural_ndcg,
                                                       ring_soft_rank)

        l_l, m_l = seq.block(labels, 1), seq.block(mask, 1, False)
        sigma = float(paras.get("sigma", 1.0))
        top_k = paras.get("top_k")
        top_k = None if top_k is None else int(top_k)
        # the ideal DCG the dense losses divide by, EPSILON floor included
        idcg = torch.clamp(_full_dcg(labels, mask, lt), min=EPSILON)[..., None]
        if model_id == "RankNet":  # pairs over the given (presorted) order, unweighted
            return ring_lambda_loss(scores, l_l, torch.zeros_like(scores), m_l, cp,
                                    sigma=sigma, weighted=False)
        if model_id in ("ApproxNDCG", "SoftRank"):  # no sort: the given order
            n_gains = seq.block(torch.where(mask, gain(torch.where(mask, labels, 0.0), lt)
                                            / idcg, 0.0), 1)
            if model_id == "ApproxNDCG":
                return ring_approx_ndcg(scores, n_gains, m_l, cp,
                                        alpha=float(paras.get("alpha", 10.0)))
            return ring_soft_rank(scores, n_gains, m_l, cp, delta=float(paras.get("delta", 2.0)),
                                  top_k=top_k)
        if model_id == "WassRank":
            return cp_wass_rank(
                scores, l_l, m_l, cp, mode=paras.get("mode", "SinkhornOT"),
                sh_itr=int(paras.get("sh_itr", 20)), lam=float(paras.get("lam", 0.1)),
                smooth_type=paras.get("smooth_type", "ST"), cost_type=paras.get("cost_type", "eg"),
                non_rele_gap=float(paras.get("non_rele_gap", 100.0)),
                var_penalty=float(paras.get("var_penalty", math.e)),
                gain_base=float(paras.get("gain_base", 4.0)), tl_af=paras.get("tl_af", "S"))
        if model_id == "NeuralNDCG":
            return ring_neural_ndcg(scores, l_l, m_l, cp,
                                    temperature=float(paras.get("temperature", 1.0)),
                                    top_k=top_k,
                                    sinkhorn_iters=int(paras.get("sinkhorn_iters", 10)),
                                    label_type=lt)
        # the sorted-order losses: the rows gathered (their gradient summed
        # back) and sorted whole, then each rank takes its block of the order
        s_full = seq.gather_sum(scores, 1)
        n_pad = s_full.shape[1]
        s_sorted, l_sorted, m_sorted = sort_labels_by_scores(
            s_full, _pad_rows(labels, n_pad, 1, 0.0), _pad_rows(mask, n_pad, 1, False))
        n_gains = torch.where(m_sorted, gain(torch.where(m_sorted, l_sorted, 0.0), lt) / idcg,
                              0.0)
        blocks = [seq.block(t, 1) for t in (s_sorted, l_sorted, n_gains, m_sorted)]
        if model_id == "LambdaLoss":
            return ring_lambdaloss(*blocks, cp, loss_type=paras.get("loss_type", "NDCG_Loss2"),
                                   k=int(paras.get("k", 5)), sigma=sigma,
                                   mu=float(paras.get("mu", 5.0)))
        return ring_lambda_loss(*blocks, cp, sigma=sigma, weighted=True)
