"""The native GBDT: histogram-based gradient-boosted trees with the trees grown
on the card (model id TPUGBDTLambdaMART).

Counterpart of ptranking_tpu/tree/jax_gbdt.py: the same algorithm, level by
level to a fixed depth:

  * features are quantile-binned once on the host (int32 bins, numpy, as in
    the JAX package);
  * each level's (node, feature, bin) gradient and hessian histograms are a
    scatter-add over [docs x features] on the card, in blocks of features;
  * the split search is a cumsum and an argmax over the histograms, with the
    0/0-guarded gain, `min_child_hessian`, the feature mask and the no-op
    split (everything left) where no split gains;
  * leaves are Newton steps -G / (H + l2);

and the same boosting loop: the ranking objective's grad and hess in numpy
on the host (tree/objectives.py), group-aware bagging, feature fraction and
early stopping on validation nDCG, drawn from `random_state` as the JAX
package draws them.

Determinism. A float scatter-add on CUDA adds with atomics in no fixed
order, so two fits could grow different trees. Here every histogram and leaf
sum is exact: grad and hess are carried as 64-bit fixed-point integers (a
power-of-two scale per tree and column, chosen from the largest magnitude
and the doc count so that no sum can overflow), summed with integer
scatter-adds, cumulated in int64 and only then turned into fp32 for the gain
and the leaves. Integer sums do not depend on their order, so the card grows
the same tree on every run and the same tree as the CPU. Values that are
multiples of the scale's step (dyadic grad and hess) carry over exactly, so
on them the trees equal the JAX package's, whose fp32 sums are then exact
too; elsewhere the sums are at least as accurate as fp32's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.tree.objectives import CUSTOM_OBJECTIVES

# features a histogram block: one scatter-add covers [FEATURE_BLOCK x docs]
FEATURE_BLOCK = 8
# the fixed-point sums stay below 2**FIXED_BITS
FIXED_BITS = 62


# --- feature quantization (host numpy, as in the JAX package) ---------------


def quantile_bin_edges(data: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges [F, num_bins - 1], padded with +inf where
    a feature has fewer distinct quantiles (those bins stay empty)."""
    n, F = data.shape
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    edges = np.full((F, num_bins - 1), np.inf, dtype=np.float64)
    for f in range(F):
        e = np.unique(np.quantile(data[:, f], qs))
        e = e[np.isfinite(e)]
        edges[f, : len(e)] = e
    return edges


def bin_features(data: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """float features [n, F] -> int32 bins [n, F]: bin = #edges < x, so bin b
    covers (edges[b-1], edges[b]]."""
    n, F = data.shape
    out = np.empty((n, F), dtype=np.int32)
    for f in range(F):
        out[:, f] = np.searchsorted(edges[f], data[:, f], side="left")
    return out


# --- exact sums ------------------------------------------------------------


def fixed_point_scale(values: torch.Tensor, n: int) -> int:
    """The power-of-two exponent s of the fixed-point form of `values` [n]:
    |v| < 2**e for every v, and n values of magnitude below
    2**(FIXED_BITS - bits(n)) sum below 2**FIXED_BITS."""
    vmax = float(torch.max(torch.abs(values))) if values.numel() else 0.0
    e = math.frexp(vmax)[1]  # vmax < 2**e; frexp(0) gives e = 0
    return FIXED_BITS - e - max(int(n).bit_length(), 1)


def to_fixed(values: torch.Tensor, s: int) -> torch.Tensor:
    """fp32 values -> int64 round(v * 2**s) (exact for multiples of 2**-s)."""
    return torch.round(values.to(torch.float64) * (2.0 ** s)).to(torch.int64)


def from_fixed(sums: torch.Tensor, s: int) -> torch.Tensor:
    """int64 sums at scale 2**s -> fp32."""
    return (sums.to(torch.float64) * (2.0 ** -s)).to(torch.float32)


def level_histograms(bins_blocks: torch.Tensor, local: torch.Tensor, gh_src: torch.Tensor,
                     num_nodes: int, num_bins: int) -> torch.Tensor:
    """Exact (node, feature, bin) sums of the fixed-point grad and hess.

    bins_blocks: [nb, FB, n] int bins, features in blocks of FB; local: [n]
    int64 node of each doc within the level; gh_src: [FB * n, 2] int64, the
    docs' fixed-point (grad, hess) repeated once for each feature of a block.
    Returns [num_nodes, nb * FB, num_bins, 2] int64: one integer scatter-add
    a block, whose sums do not depend on the order of the adds."""
    nb, FB, n = bins_blocks.shape
    fb_off = (torch.arange(FB, device=local.device, dtype=torch.int64) * num_bins)[:, None]
    node_off = (local * (FB * num_bins))[None, :]
    blocks = []
    for blk in bins_blocks:
        seg = (node_off + fb_off + blk).reshape(-1)  # [FB * n]
        h = torch.zeros(num_nodes * FB * num_bins, 2, dtype=torch.int64, device=local.device)
        h.index_add_(0, seg, gh_src)
        blocks.append(h.reshape(num_nodes, FB, num_bins, 2))
    return torch.cat(blocks, dim=1)


def _score(g: torch.Tensor, h: torch.Tensor, l2: float) -> torch.Tensor:
    # 0/0 guard: an empty child with l2 = 0 scores 0, not NaN (a NaN gain
    # would make argmax pick an arbitrary split over the no-op)
    denom = h + l2
    return torch.where(denom > 0, torch.square(g) / torch.where(denom > 0, denom, 1.0), 0.0)


# --- one tree ----------------------------------------------------------------


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor, depth: int,
              num_bins: int, l2: float, min_child_hessian: float,
              feat_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grow one depth-`depth` tree level by level on bins' device.

    bins [n, F] int32, grad and hess [n] fp32, feat_mask [F] bool (False: the
    feature is not splittable in this tree). Returns (split_feat [2^depth - 1]
    int32, split_bin [2^depth - 1] int32, leaf_value [2^depth] fp32). Nodes
    are heap-ordered (the children of i are 2i+1 and 2i+2); a doc goes left
    when bins[doc, feat] <= split_bin. A node with no profitable split gets
    the no-op split (feat 0, bin num_bins - 1: everything left)."""
    n, F = bins.shape
    dev = bins.device
    FB = min(F, FEATURE_BLOCK)
    nb = -(-F // FB)
    bins_T = bins.t()
    if nb * FB != F:
        # padded features put every doc in bin 0: zero gain, never chosen
        bins_T = torch.nn.functional.pad(bins_T, (0, 0, 0, nb * FB - F))
    bins_blocks = bins_T.reshape(nb, FB, n)
    gh = torch.stack([grad.to(torch.float32), hess.to(torch.float32)], dim=-1)  # [n, 2]
    scales = [fixed_point_scale(gh[:, c], n) for c in range(2)]
    gh_fixed = torch.stack([to_fixed(gh[:, c], scales[c]) for c in range(2)], dim=-1)
    gh_src = gh_fixed.repeat(FB, 1)  # [FB * n, 2], feature-major like the index
    if feat_mask is not None:
        feat_mask = feat_mask.to(device=dev, dtype=torch.bool)

    node = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    split_feats: List[torch.Tensor] = []
    split_bins: List[torch.Tensor] = []
    for level in range(depth):
        num_nodes = 1 << level
        local = node - (num_nodes - 1)
        hist = level_histograms(bins_blocks, local, gh_src, num_nodes, num_bins)[:, :F]
        cum = torch.cumsum(hist, dim=2)          # left sums at each bin, exact
        total = cum[:, :1, -1:, :]               # [nodes, 1, 1, 2]
        right = total - cum
        gl, hl = from_fixed(cum[..., 0], scales[0]), from_fixed(cum[..., 1], scales[1])
        gr, hr = from_fixed(right[..., 0], scales[0]), from_fixed(right[..., 1], scales[1])
        gt, ht = from_fixed(total[..., 0], scales[0]), from_fixed(total[..., 1], scales[1])

        gain = _score(gl, hl, l2) + _score(gr, hr, l2) - _score(gt, ht, l2)  # [nodes, F, bins]
        ok = (hl >= min_child_hessian) & (hr >= min_child_hessian)
        gain = torch.where(ok, gain, -math.inf)
        if feat_mask is not None:
            gain = torch.where(feat_mask[None, :, None], gain, -math.inf)

        flat = gain.reshape(num_nodes, F * num_bins)
        best = torch.argmax(flat, dim=1)  # the first of equal maxima, as jnp.argmax
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        noop = ~(best_gain > 0.0)
        bf = torch.where(noop, 0, best // num_bins).to(torch.int32)
        bb = torch.where(noop, num_bins - 1, best % num_bins).to(torch.int32)
        split_feats.append(bf)
        split_bins.append(bb)

        doc_bin = bins[rows, bf[local].long()]
        node = 2 * node + 1 + (doc_bin > bb[local]).to(torch.int64)

    num_leaves = 1 << depth
    sums = torch.zeros(num_leaves, 2, dtype=torch.int64, device=dev)
    sums.index_add_(0, node - (num_leaves - 1), gh_fixed)
    leaf_value = -from_fixed(sums[:, 0], scales[0]) / (from_fixed(sums[:, 1], scales[1]) + l2)
    return torch.cat(split_feats), torch.cat(split_bins), leaf_value


def predict_tree(bins: torch.Tensor, split_feat: torch.Tensor, split_bin: torch.Tensor,
                 leaf_value: torch.Tensor, depth: int) -> torch.Tensor:
    """Route binned docs [n, F] down one tree; returns their leaf values [n]."""
    n = bins.shape[0]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    for _ in range(depth):
        doc_bin = bins[rows, split_feat[node].long()]
        node = 2 * node + 1 + (doc_bin > split_bin[node]).to(torch.int64)
    return leaf_value[node - (leaf_value.shape[0] - 1)]


def predict_forest(bins: torch.Tensor, split_feats: torch.Tensor, split_bins: torch.Tensor,
                   leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Stacked trees [T, ...] -> summed raw scores [n] (fp32, tree by tree in
    order, as the JAX package's scan sums them)."""
    out = torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)
    for sf, sb, lv in zip(split_feats, split_bins, leaf_values):
        out = out + predict_tree(bins, sf, sb, lv, depth)
    return out


# --- boosting ----------------------------------------------------------------------


@dataclass
class GBDTConfig:
    """The JAX package's GBDTConfig: LightGBM's defaults where they carry
    over (lr .05, 1000 trees); depth 8 (256 leaves) stands in for
    num_leaves 400 (level-wise growth)."""
    num_trees: int = 1000
    learning_rate: float = 0.05
    max_depth: int = 8
    num_bins: int = 64
    l2: float = 0.0
    min_child_hessian: float = 1e-3
    objective: str = "lambdarank_newton"  # key into CUSTOM_OBJECTIVES
    early_stopping_rounds: int = 200
    vali_k: int = 5
    # LightGBM's names and meaning, off by default: feature_fraction draws the
    # splittable features of each tree; bagging draws a subset of QUERIES
    # every bagging_freq trees (lambda gradients are exchangeable only
    # within a query)
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    random_state: int = 137

    @classmethod
    def from_paras(cls, paras: Optional[dict], **overrides) -> "GBDTConfig":
        """GBDTConfig fields or LightGBM-style keys (so the LightGBM -> native
        fallback takes the caller's para_dict): num_leaves -> max_depth =
        ceil(log2(.)), num_iterations -> num_trees; other unknown keys are
        ignored with a notice."""
        paras = dict(paras or {})
        # the reference nests LightGBM keys under lightgbm_para_dict and the
        # custom-objective switches under custom_dict: flatten both
        paras.update(paras.pop("lightgbm_para_dict", {}) or {})
        custom = paras.pop("custom_dict", {}) or {}
        if custom.get("custom") and custom.get("custom_obj_id"):
            paras.setdefault("objective", custom["custom_obj_id"])
        if "num_leaves" in paras and "max_depth" not in paras:
            paras["max_depth"] = max(2, math.ceil(math.log2(max(paras.pop("num_leaves"), 2))))
        if "num_trees" not in paras and "num_iterations" in paras:
            paras["num_trees"] = paras.pop("num_iterations")
        # Newton leaves need positive hessians: the signed-hessian objectives
        # map onto their Newton-safe equivalent
        if paras.get("objective") in ("lambdarank", "ranknet"):
            print(f" [gbdt] objective {paras['objective']!r} uses the reference's "
                  "signed pair hessian; using 'lambdarank_newton' for Newton leaves")
            paras["objective"] = "lambdarank_newton"
        known = {f.name for f in dataclasses.fields(cls)}
        dropped = sorted(set(paras) - known)
        if dropped:
            print(f" [gbdt] ignoring non-native parameters: {dropped}")
        kept = {k: v for k, v in paras.items() if k in known}
        kept.update(overrides)
        return cls(**kept)


Tree = Tuple[np.ndarray, np.ndarray, np.ndarray]  # split_feat, split_bin, leaf_value


@dataclass
class GBDTRanker:
    """Gradient-boosted LambdaMART with the trees grown on `device` (the JAX
    package's TPUGBDTRanker). fit() takes flat (data, target, group) arrays;
    the trees are kept as numpy arrays."""

    cfg: GBDTConfig = field(default_factory=GBDTConfig)
    edges: Optional[np.ndarray] = None
    trees: List[Tree] = field(default_factory=list)
    best_round: Optional[int] = None
    device: str = "cuda"

    def fit(self, data: np.ndarray, target: np.ndarray, group: np.ndarray,
            vali: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
            verbose: bool = False) -> "GBDTRanker":
        """Bin the features on the host, then boost (`boost`) on the device."""
        data = np.asarray(data, np.float64)
        self.edges = quantile_bin_edges(data, self.cfg.num_bins)
        dev = resolve_device(self.device)
        bins = torch.from_numpy(bin_features(data, self.edges)).to(dev)
        vali_binned = None
        if vali is not None:
            vdata, vtarget, vgroup = vali
            vbins = bin_features(np.asarray(vdata, np.float64), self.edges)
            vali_binned = (torch.from_numpy(vbins).to(dev), vtarget, vgroup)
        return self.boost(bins, target, group, vali_binned, verbose=verbose)

    def boost(self, bins: torch.Tensor, target: np.ndarray, group: np.ndarray,
              vali: Optional[Tuple[torch.Tensor, np.ndarray, np.ndarray]] = None,
              verbose: bool = False, timings: Optional[dict] = None) -> "GBDTRanker":
        """Boost on binned docs already on the device (bins [n, F] int32); vali
        is (bins, target, group). `timings`, when given, gathers the seconds of
        each tree's host objective ("objective") and of its growth and
        prediction on the device ("grow", with a device sync)."""
        cfg = self.cfg
        if cfg.objective in ("lambdarank", "ranknet"):
            raise ValueError(
                f"objective {cfg.objective!r} keeps the reference's signed pair hessian, "
                "which breaks the Newton leaf -G/(H+l2); use 'lambdarank_newton' "
                "(GBDTConfig.from_paras maps it automatically)")
        objective = CUSTOM_OBJECTIVES[cfg.objective][0]  # (plain, lgbm-fobj) pair
        target = np.asarray(target, np.float64)
        group = np.asarray(group, np.int64)
        dev = bins.device
        preds = np.zeros(len(target), np.float64)
        vali_best = -np.inf
        rounds_since_best = 0
        if vali is not None:
            vali_bins, vtarget, vgroup = vali
            vtarget, vgroup = np.asarray(vtarget, np.float64), np.asarray(vgroup, np.int64)
            vpreds = np.zeros(len(vtarget), np.float64)

        F = bins.shape[1]
        rng = np.random.RandomState(cfg.random_state)
        bagging = cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
        subsampling = bagging or cfg.feature_fraction < 1.0
        doc_w = np.ones(len(target))
        q_off = np.cumsum(np.concatenate([[0], group]))

        self.trees, self.best_round = [], None
        for t in range(cfg.num_trees):
            with _timed(timings, "objective", dev):
                grad, hess = objective(target, preds, group)
            feat_mask = None
            if subsampling:
                if cfg.feature_fraction < 1.0:
                    k = max(1, int(round(cfg.feature_fraction * F)))
                    chosen = rng.choice(F, size=k, replace=False)
                    fm = np.zeros(F, bool)
                    fm[chosen] = True
                    feat_mask = torch.from_numpy(fm).to(dev)
                if bagging and t % cfg.bagging_freq == 0:
                    # in-bag QUERIES keep their docs' (g, h); out-of-bag docs
                    # are zeroed and weigh nothing in histograms, gains or leaves
                    kq = max(1, int(round(cfg.bagging_fraction * len(group))))
                    in_bag = rng.choice(len(group), size=kq, replace=False)
                    doc_w = np.zeros(len(target))
                    for qi in in_bag:
                        doc_w[q_off[qi]:q_off[qi + 1]] = 1.0
                if bagging:
                    grad, hess = grad * doc_w, hess * doc_w
            with _timed(timings, "grow", dev):
                g = torch.from_numpy(grad.astype(np.float32)).to(dev)
                h = torch.from_numpy(hess.astype(np.float32)).to(dev)
                sf, sb, lv = grow_tree(bins, g, h, depth=cfg.max_depth, num_bins=cfg.num_bins,
                                       l2=cfg.l2, min_child_hessian=cfg.min_child_hessian,
                                       feat_mask=feat_mask)
                lv = lv * cfg.learning_rate
                step = predict_tree(bins, sf, sb, lv, cfg.max_depth).cpu().numpy()
                self.trees.append((sf.cpu().numpy(), sb.cpu().numpy(), lv.cpu().numpy()))
            preds += step.astype(np.float64)

            if vali is not None:
                vpreds += predict_tree(vali_bins, sf, sb, lv,
                                       cfg.max_depth).cpu().numpy().astype(np.float64)
                score = _ndcg_at_k(vpreds, vtarget, vgroup, cfg.vali_k)
                if score > vali_best:
                    vali_best, self.best_round, rounds_since_best = score, t + 1, 0
                else:
                    rounds_since_best += 1
                if verbose and (t + 1) % 50 == 0:
                    print(f"  [gbdt] round {t + 1}: vali nDCG@{cfg.vali_k}={score:.5f}"
                          f" (best {vali_best:.5f} @ {self.best_round})")
                if rounds_since_best >= cfg.early_stopping_rounds:
                    break
        if self.best_round is not None:
            self.trees = self.trees[: self.best_round]
        return self

    def predict(self, data: np.ndarray) -> np.ndarray:
        """Raw scores [n] (fp32) of float features [n, F]."""
        if self.edges is None or not self.trees:
            raise RuntimeError("fit() or load() the ranker first")
        dev = resolve_device(self.device)
        bins = torch.from_numpy(bin_features(np.asarray(data, np.float64), self.edges)).to(dev)
        stacked = [torch.from_numpy(np.stack([t[i] for t in self.trees])).to(dev)
                   for i in range(3)]
        return predict_forest(bins, *stacked, self.cfg.max_depth).cpu().numpy()

    def save(self, path: str):
        torch.save({"cfg": dataclasses.asdict(self.cfg), "edges": torch.tensor(self.edges),
                    "trees": [tuple(torch.tensor(a) for a in t) for t in self.trees],
                    "best_round": self.best_round}, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "GBDTRanker":
        d = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg=GBDTConfig(**d["cfg"]), edges=d["edges"].numpy(),
                   trees=[tuple(a.numpy() for a in t) for t in d["trees"]],
                   best_round=d["best_round"], device=device)


def gbdt_from_jax(edges: np.ndarray, trees: Sequence[Tree], cfg_fields: dict,
                  best_round: Optional[int] = None, device="cuda") -> GBDTRanker:
    """A forest fitted by the JAX package (its edges, trees and
    GBDTConfig fields as plain numpy arrays and a dict) as the port's
    ranker. The JAX pickle holds the JAX package's dataclass, which the port
    does not import, so the caller passes its fields."""
    return GBDTRanker(cfg=GBDTConfig(**cfg_fields), edges=np.asarray(edges, np.float64),
                      trees=[tuple(np.asarray(a) for a in t) for t in trees],
                      best_round=best_round, device=device)


@contextlib.contextmanager
def _timed(timings: Optional[dict], name: str, device: torch.device):
    """Adds the seconds of the block to timings[name] (a list a name), after a
    device sync; a no-op without timings."""
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings.setdefault(name, []).append(time.perf_counter() - t0)


def _ndcg_at_k(preds: np.ndarray, labels: np.ndarray, group: np.ndarray, k: int) -> float:
    """Mean nDCG@k over flat query groups (host numpy; early stopping only)."""
    vals, head = [], 0
    for g in group.astype(int):
        p, l = preds[head:head + g], labels[head:head + g]
        head += g
        kk = min(k, g)
        order = np.argsort(-p, kind="stable")
        gains = (2.0 ** l[order][:kk] - 1.0) / np.log2(np.arange(kk) + 2.0)
        igains = (2.0 ** np.sort(l)[::-1][:kk] - 1.0) / np.log2(np.arange(kk) + 2.0)
        denom = igains.sum()
        vals.append(gains.sum() / denom if denom > 0 else 0.0)
    return float(np.mean(vals)) if vals else 0.0
