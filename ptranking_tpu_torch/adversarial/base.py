"""Adversarial base: players (G/D) and the minimax machine protocol.

The port's copy of ptranking_tpu/adversarial/base.py. A player is an
AdhocRanker (scorer params, its own torch.optim optimizer from
`make_optimizer`, predict / evaluate / checkpoints) with a score
temperature. A machine owns both players and one torch.Generator on their
device, seeded from its seed; each of its steps is a plain function of
device tensors (features [B, N, F], labels [B, N], mask [B, N]) that takes
one optimizer step and returns the loss as a device tensor. A step's draws
come from the machine's generator unless the caller passes them (`draws`,
a dict by name), so a test can replay the JAX package's.

A pass walks the epoch's batches in chunks of `scan_steps` same-shape
batches (utils/chunking.py, the JAX package's boundaries) and waits for the
device once a chunk, to check that the chunk's loss is finite. The
training data is either batches (streamed: each batch copied to the device
in each pass) or a DeviceResidentDataset (resident: one index copy a chunk
an epoch, made when the first pass reaches the chunk and shared by the
later passes; each batch an index_select on the device).

With `mesh=` both players are data-parallel, as in the JAX package: each
rank takes its block of every batch's rows, the samplers draw for the
global batch, the masked means divide by counts summed over the ranks and
each update sums the players' gradients over the ranks
(parallel/collectives.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset, take_features
from ptranking_tpu_torch.models.scorers import ScorerConfig, apply_scorer
from ptranking_tpu_torch.parallel.collectives import global_count
from ptranking_tpu_torch.parallel.mesh import data_parallel
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker, _to_device
from ptranking_tpu_torch.utils.chunking import iter_shape_chunks


class AdversarialPlayer(AdhocRanker):
    """G/D are AdhocNeuralRankers in the reference (ad_player.py:6-12); here
    they are AdhocRankers with a score temperature (irgan_point.py:23-33).
    As in the JAX package, the machines' forwards pass no dropout draws, so
    the scorer's dropout never applies in minimax training."""

    def __init__(self, scorer_cfg: ScorerConfig, opt_cfg: Optional[OptimizerConfig] = None,
                 temperature: Optional[float] = None, seed: int = 137, device="cuda"):
        # RankMSE is a placeholder loss: players train through machine steps
        super().__init__("RankMSE", scorer_cfg, opt_cfg=opt_cfg, seed=seed, device=device)
        self.temperature = temperature

    def scaled(self, scores: torch.Tensor) -> torch.Tensor:
        """scores / temperature, unless the temperature is None or 1."""
        if self.temperature is not None and self.temperature != 1.0:
            return scores / self.temperature
        return scores

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                training: bool = True) -> torch.Tensor:
        """Scores [B, N] that carry the gradient to the player's params."""
        return apply_scorer(self.params, self.scorer_cfg, features, mask, training=training)

    @torch.no_grad()
    def predict_scaled(self, features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.scaled(apply_scorer(self.params, self.scorer_cfg, features, mask))

    @torch.no_grad()
    def predict_raw(self, features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Unscaled scores without a gradient (the other player's view)."""
        return apply_scorer(self.params, self.scorer_cfg, features, mask)

    def update(self, loss_of: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One optimizer step on loss_of(); returns the loss, detached, on
        the device."""
        self._optimizer.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        self._dp.reduce_grads(self._leaves)
        self._optimizer.step()
        return loss.detach()


def masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sum(x over m) / max(count(m), 1); the count spans every rank's rows
    under data parallelism."""
    return (torch.sum(torch.where(m, x, 0.0))
            / torch.clamp(global_count(torch.sum(m)), min=1).float())


def num_pos(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum((labels > 0) & mask, dim=-1)  # [B]


def gather_docs(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, F], idx [B, S] -> [B, S, F]."""
    return features[torch.arange(features.shape[0], device=idx.device)[:, None], idx]


class _ResidentEpoch:
    """One epoch's batch schedule over a DeviceResidentDataset: its index
    chunks, each copied to the device when the first pass reaches it and
    walked again by every later pass."""

    def __init__(self, res: DeviceResidentDataset, epoch_k: int, shuffle: bool, chunk: int,
                 dp):
        self.res = res
        # this rank's columns of each chunk under data parallelism
        self._host = [(bucket, dp.shard_index(idx_k, res.bucket_arrays(bucket)[2].shape[0] - 1))
                      for bucket, idx_k, _ in res.epoch_index_chunks(shuffle, epoch_k, chunk)]
        self._dev = {}

    def chunks(self):
        """(bucket, idx [k, B] on the device) in schedule order."""
        for i, (bucket, idx_k) in enumerate(self._host):
            if i not in self._dev:
                self._dev[i] = self.res.index_to_device(idx_k)
            yield bucket, self._dev[i]


class AdversarialMachine:
    """Abstract minimax trainer (reference ad_machine.py:5-55)."""

    def __init__(self, sf_para: Dict[str, Any], ad_para_dict: Dict[str, Any],
                 mesh=None, device="cuda"):
        # the players' share of data-parallel work (SINGLE without a mesh);
        # init_minimax hands it to both players
        self._dp = data_parallel(mesh)
        self.ad_para_dict = ad_para_dict
        # batches a chunk of the D/G passes: the host checks the loss once a
        # chunk; it changes no value
        self.scan_steps = max(int(ad_para_dict.get("scan_steps", 8)), 1)
        self.device = resolve_device(device)

    def _seed(self, seed: int):
        """The machine's generator (the JAX package's self._key)."""
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- passes

    def _epoch_data(self, train_data, epoch_k: int, shuffle: bool):
        """The epoch's batch schedule: a _ResidentEpoch for a
        DeviceResidentDataset, else the list of its batches (a dataset's
        `batches(shuffle, epoch)`, or the batches as given)."""
        if isinstance(train_data, DeviceResidentDataset):
            return _ResidentEpoch(train_data, epoch_k, shuffle, self.scan_steps, self._dp)
        if hasattr(train_data, "batches"):
            train_data = train_data.batches(shuffle=shuffle, epoch=epoch_k)
        return list(train_data)

    def _chunks(self, data) -> Iterable[List[tuple]]:
        """The pass's chunks, each a list of device (features, labels, mask)."""
        if isinstance(data, _ResidentEpoch):
            for bucket, idx_k in data.chunks():
                feats, labels, mask = data.res.bucket_arrays(bucket)
                yield [(take_features(feats, idx), labels.index_select(0, idx).float(),
                        mask.index_select(0, idx)) for idx in idx_k]
            return
        dp = self._dp
        for chunk, _ in iter_shape_chunks(data, self.scan_steps):
            yield [(_to_device(dp.shard(b.features), self.device, torch.float32),
                    _to_device(dp.shard(b.labels), self.device, torch.float32),
                    _to_device(dp.shard(b.mask), self.device, torch.bool)) for b in chunk]

    def _fused_pass(self, step, data) -> bool:
        """One pass of `step` over the batches; returns True when a chunk's
        loss (summed over the ranks) went non-finite (the pass stops there),
        the host's only wait of the pass."""
        for chunk in self._chunks(data):
            losses = []
            for batch in chunk:
                with self._dp.rows(batch[0].shape[0]):
                    losses.append(step(*batch))
            if not bool(torch.isfinite(self._dp.all_reduce(torch.stack(losses).sum()))):
                return True
        return False

    def _d_pass(self, data):
        self._fused_pass(self._d_step, data)

    def _g_pass(self, data) -> bool:
        return self._fused_pass(self._g_step, data)

    def mini_max_train(self, train_data=None, epoch_k: int = 0, shuffle: bool = True) -> bool:
        """One minimax round over `train_data` (batches, a dataset, or a
        DeviceResidentDataset whose epoch `epoch_k` schedule it walks):
        d_epoches D passes and g_epoches G passes in ad_training_order.
        Returns True when a G pass went non-finite (stop)."""
        data = self._epoch_data(train_data, epoch_k, shuffle)
        if self.ad_training_order == "DG":
            for _ in range(self.d_epoches):
                self._d_pass(data)
            for _ in range(self.g_epoches):
                if self._g_pass(data):
                    return True
        else:
            for _ in range(self.g_epoches):
                if self._g_pass(data):
                    return True
            for _ in range(self.d_epoches):
                self._d_pass(data)
        return False

    def pre_check(self):
        pass

    def burn_in(self, train_data=None):
        pass

    def fill_global_buffer(self, train_data=None):
        pass

    def reset_generator(self):
        self.generator.init()

    def reset_discriminator(self):
        self.discriminator.init()

    def reset_generator_discriminator(self):
        self.reset_generator()
        self.reset_discriminator()

    def get_generator(self) -> AdversarialPlayer:
        return self.generator

    def get_discriminator(self) -> AdversarialPlayer:
        return self.discriminator


def draw(draws: Optional[Dict[str, Any]], name: str):
    """The injected draw `name`, or None (the sampler then draws)."""
    return None if draws is None else draws.get(name)

