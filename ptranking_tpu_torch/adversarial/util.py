"""Adversarial-branch utilities: ranking log-probs, masked sampling, the
f-divergence table and the pair samplers.

The port's copy of ptranking_tpu/adversarial/util.py. Every sampler draws
from an explicit `gen` (a torch.Generator on the tensors' device) and also
accepts the draw itself (`idx=` for a categorical draw, `unif=` for the
uniforms a Gumbel or Bernoulli draw is made from), so a test can inject the
JAX package's draws. Nobody matches the JAX RNG stream: the draws are held
to their distributions.

Categorical draws with replacement are inverse-CDF draws in fp64 (one
softmax, one cumsum, one searchsorted a row), never `torch.multinomial`:
a row whose logits are all PAD_SCORE (finite) is a uniform row and draws
without error, as `jax.random.categorical` does, and an entry of
probability 0 is never drawn. Pair draws over the flattened [N * N] axis
take the same route and never materialise a [B, S, N * N] noise tensor.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.ops.cumulative import logcumsumexp_reverse
from ptranking_tpu_torch.parallel.collectives import batch_rand, global_count

_EPS = 1e-20


def log_ranking_prob_pl(preds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plackett-Luce log prob of the GIVEN order (reference
    log_ranking_prob_Plackett_Luce, list_probability.py:24-31). [..., N] -> [...]."""
    lcse = logcumsumexp_reverse(preds, mask)
    return torch.sum(torch.where(mask, preds - lcse, 0.0), dim=-1)


def log_ranking_prob_bt(preds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bradley-Terry log prob over upper-triangular pairs (reference
    log_ranking_prob_Bradley_Terry, list_probability.py:42-62)."""
    n = preds.shape[-1]
    log_bt = F.logsigmoid(preds[..., :, None] - preds[..., None, :])
    i = torch.arange(n, device=preds.device)
    triu = i[:, None] < i[None, :]
    valid = (mask[..., :, None] & mask[..., None, :]) & triu
    return torch.sum(torch.where(valid, log_bt, 0.0), dim=(-2, -1))


def _injected(x, device, dtype=None) -> torch.Tensor:
    """An injected draw (a tensor or an array, read-only ones included) as a
    tensor on `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype)


def _uniform(shape, device, gen: Optional[torch.Generator], unif=None,
             dtype=torch.float32) -> torch.Tensor:
    """`unif` as a tensor on `device` when given, else U[0, 1) draws from `gen`."""
    if unif is not None:
        return _injected(unif, device, dtype).reshape(shape)
    return batch_rand(shape, gen, device, dtype)


def categorical(logits: torch.Tensor, num_samples: int, gen: Optional[torch.Generator] = None,
                idx=None) -> torch.Tensor:
    """[..., N] logits -> [..., num_samples] int64 indices ~ softmax(logits),
    with replacement: the inverse CDF of the fp64 softmax at
    u * total (u ~ U[0, 1) in fp64, so u * total < total). The first index
    whose CDF exceeds the draw is taken, so an entry of probability 0 is
    never drawn; a row of equal logits (all PAD_SCORE) is uniform. `idx`
    given is returned as the draw."""
    lead, n = logits.shape[:-1], logits.shape[-1]
    if idx is not None:
        return _injected(idx, logits.device, torch.int64).reshape(*lead, num_samples)
    p = torch.softmax(logits.detach().reshape(-1, n).double(), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    u = _uniform((p.shape[0], num_samples), logits.device, gen, dtype=torch.float64)
    out = torch.searchsorted(cdf, u * cdf[:, -1:], right=True).clamp_max_(n - 1)
    return out.reshape(*lead, num_samples)


def _gumbel(unif: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(unif + _EPS) + _EPS)


def sample_categorical_masked(logits: torch.Tensor, mask: torch.Tensor, num_samples: int,
                              replacement: bool = True, gen: Optional[torch.Generator] = None,
                              idx=None, unif=None) -> torch.Tensor:
    """Sample indices ~ softmax(logits) over valid entries.
    logits/mask [..., N] -> [..., num_samples]. With replacement: `categorical`
    (`idx=` injects the draw). Without: the Gumbel top-k trick (equivalent to
    sequential multinomial sampling; `unif=` [..., N] injects the uniforms),
    ties, such as pads, in index order as in JAX's stable argsort."""
    masked = torch.where(mask, logits.detach(), PAD_SCORE)
    if replacement:
        return categorical(masked, num_samples, gen, idx)
    noisy = masked + _gumbel(_uniform(masked.shape, masked.device, gen, unif))
    return torch.argsort(-noisy, dim=-1, stable=True)[..., :num_samples]


def sample_uniform_positions(counts: torch.Tensor, num_samples: int, upper: int,
                             gen: Optional[torch.Generator] = None, unif=None) -> torch.Tensor:
    """counts [...]: per-row number of valid leading positions. Returns
    [..., num_samples] indices uniform over [0, counts) (with replacement),
    clipped safe when counts==0. `unif` [..., num_samples] injects the
    uniforms."""
    u = _uniform((*counts.shape, num_samples), counts.device, gen, unif)
    idx = torch.floor(u * torch.clamp(counts, min=1)[..., None].float()).long()
    return torch.clamp(idx, 0, upper - 1)


# --- f-divergences (reference f_divergence.py:9-76) --------------------------


def get_f_divergence_functions(f_div_str: str) -> Tuple[Callable, Callable]:
    """(activation, conjugate) pair per divergence id."""
    if f_div_str == "TVar":
        return (lambda v: 0.5 * torch.tanh(v)), (lambda t: t)
    if f_div_str == "KL":
        return (lambda v: v), (lambda t: torch.exp(t - 1.0))
    if f_div_str == "RKL":
        return (lambda v: -torch.exp(-v)), \
               (lambda t: -1.0 - torch.log(torch.clamp(-t, min=1e-20)))
    if f_div_str == "PC":
        return (lambda v: v), (lambda t: 0.25 * t * t + t)
    if f_div_str == "NC":
        return (lambda v: 1.0 - torch.exp(-v)), \
               (lambda t: 2.0 - 2.0 * torch.sqrt(torch.clamp(1.0 - t, min=1e-20)))
    if f_div_str == "SH":
        return (lambda v: 1.0 - torch.exp(-v)), (lambda t: t / torch.clamp(1.0 - t, min=1e-8))
    if f_div_str == "JS":
        return (lambda v: math.log(2.0) - torch.log1p(torch.exp(-v))), \
               (lambda t: -torch.log(torch.clamp(2.0 - torch.exp(t), min=1e-20)))
    if f_div_str == "JSW":
        pi = math.pi
        return (lambda v: -pi * math.log(pi) - torch.log1p(torch.exp(-v))), \
               (lambda t: (1.0 - pi) * torch.log(torch.clamp(
                   (1.0 - pi) / torch.clamp(1.0 - pi * torch.exp(t / pi), min=1e-20), min=1e-20)))
    if f_div_str == "GAN":
        return (lambda v: -torch.log1p(torch.exp(-v))), \
               (lambda t: -torch.log(torch.clamp(1.0 - torch.exp(t), min=1e-20)))
    raise NotImplementedError(f_div_str)


F_DIVERGENCES = ["TVar", "KL", "RKL", "PC", "NC", "SH", "JS", "JSW", "GAN"]


# --- listwise sampling helpers shared by IRGAN_List / IRFGAN_List -------------


def sample_pl_rankings(scores: torch.Tensor, mask: torch.Tensor, S: int, k: int,
                       temperature: float, gen: Optional[torch.Generator] = None,
                       unif=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-softmax PL sampling: [B, N] -> (top-k indices [B, S, k],
    top-k noisy probs [B, S, k], differentiable in `scores`) (reference
    gumbel_softmax, list_sampling.py:16-36 + sort). `unif` [B, S, N]
    injects the uniforms; pads (all PAD_SCORE) tie in index order."""
    B, N = scores.shape
    gumbel = _gumbel(_uniform((B, S, N), scores.device, gen, unif))
    noisy = (scores[:, None, :] + gumbel) / temperature
    noisy = torch.where(mask[:, None, :], noisy, PAD_SCORE)
    probs = torch.softmax(noisy, dim=-1)
    order = torch.argsort(-noisy.detach(), dim=-1, stable=True)[..., :k]  # [B, S, k]
    return order, torch.gather(probs, -1, order)


def gather_subrankings(features: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """[B, N, F] + [B, S, k] -> [B*S, k, F]."""
    B, S, k = order.shape
    rows = torch.arange(B, device=order.device)[:, None, None]
    return features[rows, order].reshape(B * S, k, features.shape[-1])


def shuffled_truth_rankings(labels: torch.Tensor, mask: torch.Tensor, S: int, k: int,
                            gen: Optional[torch.Generator] = None, unif=None) -> torch.Tensor:
    """Per-sample tie-shuffled truth top-k indices [B, S, k]; `unif`
    [B, S, N] injects the uniforms."""
    B, N = labels.shape
    u = _uniform((B, S, N), labels.device, gen, unif)
    skey = torch.where(mask[:, None, :], labels[:, None, :].float(), PAD_SCORE)
    noisy = skey + 1e-3 * u  # stable label-desc sort + tie shuffle
    return torch.argsort(-noisy, dim=-1, stable=True)[..., :k]


def subranking_masks(mask: torch.Tensor, S: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sub_mask [B*S, k], row_weight [B*S]) for top-k sub-rankings.

    sub_mask marks positions beyond a query's real doc count as pads (a
    short list cannot fill its top-k), and row_weight zeroes all-padded
    remainder queries of bucketed batches so they never train G or D."""
    n_valid = torch.sum(mask, dim=-1)  # [B]
    sub = torch.arange(k, device=mask.device)[None, :] < torch.clamp(n_valid, max=k)[:, None]
    sub_mask = torch.repeat_interleave(sub, S, dim=0)  # row-major, as reshape(B*S, ...)
    w = torch.repeat_interleave((n_valid > 0).float(), S, dim=0)
    return sub_mask, w


def weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(x * w) / max(sum(w), 1); the weights' sum spans every rank's rows
    under data parallelism."""
    return torch.sum(x * w) / torch.clamp(global_count(torch.sum(w)), min=1.0)


# --- pair sampling (reference ltr_adversarial/util/pair_sampling.py:27-150) ---
#
# The reference's per-qid Python loops with torch.multinomial become batched
# [B, N, N] weight matrices + one categorical draw over the flattened pair
# axis, as in the JAX package.


def weighted_clipped_pos_diffs(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Position-discounted positive label gaps [B, N, N] (reference
    get_weighted_clipped_pos_diffs, pair_sampling.py:26-51): w_ij =
    max(l_i - l_j, 0) / (log2(2+i) * log2(2+j)), judged (label >= 0) tails
    only (the reference's num_explicit column clip)."""
    n = labels.shape[-1]
    diffs = torch.clamp(labels[..., :, None] - labels[..., None, :], min=0.0)
    disc = 1.0 / torch.log2(2.0 + torch.arange(n, device=labels.device, dtype=labels.dtype))
    w = diffs * disc[None, :, None] * disc[None, None, :]
    explicit_tail = labels[..., None, :] >= 0
    valid = mask[..., :, None] & mask[..., None, :] & explicit_tail
    return torch.where(valid, w, 0.0)


def _flat_pair_sample(weights: torch.Tensor, num_pairs: int, gen, idx=None):
    """weights [B, N, N] -> (head [B, S], tail [B, S]) ~ categorical over the
    flattened pair axis, with replacement; `idx` [B, S] (head * N + tail)
    injects the draw."""
    B, N, _ = weights.shape
    logits = torch.log(torch.clamp(weights.reshape(B, N * N), min=_EPS))
    flat = categorical(logits, num_pairs, gen, idx)
    return flat // N, flat % N


def generate_true_pairs(labels: torch.Tensor, mask: torch.Tensor, num_pairs: int,
                        gen: Optional[torch.Generator] = None, idx=None):
    """Discounted true-pair sampling (reference generate_true_pairs,
    pair_sampling.py:53-78): (head, tail, has_pairs[B])."""
    w = weighted_clipped_pos_diffs(labels, mask)
    head, tail = _flat_pair_sample(w, num_pairs, gen, idx)
    return head, tail, torch.sum(w, dim=(-2, -1)) > 0


def sample_points_bernoulli(mat_probs: torch.Tensor, num_pairs: int,
                            gen: Optional[torch.Generator] = None, unif=None, idx=None):
    """Two-stage Bernoulli-then-multinomial pair draw (reference
    sample_points_Bernoulli, pair_sampling.py:112-124): b ~ Bernoulli(p) per
    pair, then uniform among successes, with replacement. Rows with zero
    successes fall back to p itself, and a row of p all 0 is uniform (the
    reference would raise on an all-zero multinomial). `unif` [B, N * N]
    injects the Bernoulli uniforms, `idx` [B, S] the flat draw."""
    B, N, _ = mat_probs.shape
    flat = mat_probs.reshape(B, N * N)
    if idx is None:
        b = _uniform(flat.shape, flat.device, gen, unif) < torch.clamp(flat, 0.0, 1.0)
        weights = torch.where(torch.any(b, dim=-1, keepdim=True), b.to(flat.dtype), flat)
        flat = torch.log(torch.clamp(weights, min=_EPS))
    drawn = categorical(flat, num_pairs, gen, idx)
    return drawn // N, drawn % N


def sample_pairs_bt(point_vals: torch.Tensor, mask: torch.Tensor, num_pairs: int,
                    gen: Optional[torch.Generator] = None, unif=None, idx=None):
    """Bradley-Terry pair sampling (reference sample_pairs_BT,
    pair_sampling.py:89-110): p(d_i > d_j) = sigmoid(s_i - s_j), then the
    Bernoulli/multinomial two-stage draw."""
    probs = torch.sigmoid(point_vals[..., :, None] - point_vals[..., None, :])
    valid = mask[..., :, None] & mask[..., None, :]
    return sample_points_bernoulli(torch.where(valid, probs, 0.0), num_pairs, gen, unif, idx)


def gaussian_integral_0_inf(mu: torch.Tensor, sigma: float) -> torch.Tensor:
    """Closed form of the reference's quad() (pt_extensions.py:112-132):
    integral_0^inf N(y; mu/sigma, 1)/sigma dy = Phi(mu/sigma)/sigma.
    Faithful quirk: the extra 1/sigma factor means this is NOT a normalized
    probability (the reference feeds it to Bernoulli regardless)."""
    z = mu / sigma
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0))) / sigma


def sample_pairs_gaussian(point_vals: torch.Tensor, mask: torch.Tensor, num_pairs: int,
                          sigma: float = 1.0, gen: Optional[torch.Generator] = None,
                          unif=None, idx=None):
    """Gaussian pair sampling (reference sample_pairs_gaussian,
    pair_sampling.py:80-87): pair prob = GaussianIntegral_0_inf(s_i - s_j,
    sqrt(2)*sigma), then the Bernoulli/multinomial two-stage draw."""
    means = point_vals[..., :, None] - point_vals[..., None, :]
    probs = gaussian_integral_0_inf(means, math.sqrt(2.0) * sigma)
    valid = mask[..., :, None] & mask[..., None, :]
    return sample_points_bernoulli(torch.where(valid, probs, 0.0), num_pairs, gen, unif, idx)
