"""Diversity scorers: query-conditioned document scoring with MDN heads.

The port's copy of ptranking_tpu/diversification/scorers.py. One query's
input is (q_repr [D], doc_reprs [N, D]), batched with padding:

  * pointsf: concat(q, q*d, d) -> [B, N, 3D] -> stacked FFN;
  * listsf: cat1 = [q, d, q*d] -> the 3D-wide MHSA encoder (the dense
    attention of models/scorers/listsf.py, attention dropout included; the
    JAX package does not route it through flash attention) -> cat2 =
    [cat1, enc] [B, N, 6D] -> FFN;
  * the MDN head: out_dim 2 (K = 1: mu, var), 3K (K > 1: softmax-mixed
    components) or a cluster of K scorers each emitting 3 values;
    limit_delta caps the variance through a sigmoid;
  * the "co" variant (sf_id ending in 'co'): an extra FFN on cat2 whose
    unit outputs give a cosine-similarity correlation matrix.

A cluster's params are stacked on a leading K axis, as the JAX package's
vmap over members keeps them, so a JAX tree converts leaf for leaf. Its
members run one after another; in training each draws the same dropout
masks (the generator's state is restored before each member), as every
member gets the same PRNG key in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ptranking_tpu_torch import LTR_SEED
from ptranking_tpu_torch.models.scorers import listsf as _listsf
from ptranking_tpu_torch.models.scorers import map_params
from ptranking_tpu_torch.models.scorers.nn import Params, ffn_apply, ffn_init

SORT_ID = ["ExpRele", "RERAR", "RiskAware"]


@dataclasses.dataclass(frozen=True)
class DivScorerConfig:
    sf_id: str = "pointsf"  # pointsf | listsf | pointsf_co | listsf_co
    num_features: int = 100  # D: representation dim (TREC WT uses 100)
    # MDN head
    K: int = 1
    cluster: bool = False
    sort_id: str = "ExpRele"
    limit_delta: Optional[float] = None
    b: float = 0.1  # RiskAware trade-off
    # pointsf stack
    h_dim: int = 100
    num_layers: int = 5
    # listsf
    ff_dims: Tuple[int, ...] = (256, 128, 64)
    n_heads: int = 2
    encoder_layers: int = 2
    encoder_type: str = "AttnDIN"
    # shared
    AF: str = "R"
    TL_AF: str = "GE"
    apply_tl_af: bool = False
    BN: bool = True
    bn_type: str = "BN"
    bn_affine: bool = False
    dropout: float = 0.1

    @property
    def with_cocos(self) -> bool:
        return self.sf_id.endswith("co")

    @property
    def out_dim(self) -> int:
        if self.cluster:
            return 3
        return 2 if self.K == 1 else 3 * self.K


def _single_init(gen: torch.Generator, cfg: DivScorerConfig, device) -> Params:
    D = cfg.num_features
    if cfg.sf_id.startswith("pointsf"):
        dims = [3 * D] + [cfg.h_dim] * cfg.num_layers + [cfg.out_dim]
        return {"point_sf": ffn_init(gen, dims, BN=cfg.BN, bn_affine=cfg.bn_affine,
                                     apply_tl_af=cfg.apply_tl_af, device=device)}
    p = {
        "encoder": _listsf.encoder_init(gen, 3 * D, cfg.encoder_layers, cfg.encoder_type,
                                        device),
        "uni_sf": ffn_init(gen, [6 * D, *cfg.ff_dims, cfg.out_dim], BN=cfg.BN,
                           bn_affine=cfg.bn_affine, apply_tl_af=cfg.apply_tl_af,
                           device=device),
    }
    if cfg.with_cocos:
        p["co_ffnns"] = ffn_init(gen, [6 * D, *cfg.ff_dims, cfg.ff_dims[-1]], BN=cfg.BN,
                                 bn_affine=cfg.bn_affine, apply_tl_af=False, device=device)
    return p


def _stack(trees):
    """Stack equal-structured param trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return torch.stack(trees)


def init_div_scorer(cfg: DivScorerConfig, seed: int = LTR_SEED, device="cpu") -> Params:
    """Fresh fp32 params from a CPU torch.Generator seeded with `seed` (one
    seed gives the same params on every device), placed on `device`. A
    cluster draws its K members one after another and stacks them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if cfg.cluster:
        if cfg.K < 2 or cfg.with_cocos:
            raise ValueError(f"a cluster needs K >= 2 and no cocos, got K={cfg.K}, "
                             f"sf_id={cfg.sf_id!r}")
        return _stack([_single_init(gen, cfg, device) for _ in range(cfg.K)])
    return _single_init(gen, cfg, device)


def _single_raw_forward(params, cfg: DivScorerConfig, q_repr, doc_reprs, mask,
                        training=False, gen=None):
    """-> raw [B, N, out_dim] (and cocos [B, N, N] for the co variant)."""
    B, N, D = doc_reprs.shape
    q = q_repr[:, None, :].expand(B, N, D)
    cross = q * doc_reprs
    bn_per_query = cfg.bn_type == "BN2"
    if cfg.sf_id.startswith("pointsf"):
        cat = torch.cat([q, cross, doc_reprs], dim=-1)  # order: q, q*d, d
        out = ffn_apply(params["point_sf"], cat, mask, AF=cfg.AF, TL_AF=cfg.TL_AF,
                        apply_tl_af=cfg.apply_tl_af, BN=cfg.BN, bn_per_query=bn_per_query,
                        drop_rate=cfg.dropout, training=training, gen=gen)
        return out, None
    cat1 = torch.cat([q, doc_reprs, cross], dim=-1)  # order: q, d, q*d
    enc = _listsf.encoder_apply(params["encoder"], cat1, mask, cfg.n_heads, cfg.encoder_type,
                                drop_rate=cfg.dropout, training=training, gen=gen)
    cat2 = torch.cat([cat1, enc], dim=-1)
    out = ffn_apply(params["uni_sf"], cat2, mask, AF=cfg.AF, TL_AF=cfg.TL_AF,
                    apply_tl_af=cfg.apply_tl_af, BN=cfg.BN, bn_per_query=bn_per_query,
                    drop_rate=cfg.dropout, training=training, gen=gen)
    cocos = None
    if cfg.with_cocos:
        emb = ffn_apply(params["co_ffnns"], cat2, mask, AF=cfg.AF, apply_tl_af=False,
                        BN=cfg.BN, bn_per_query=bn_per_query, drop_rate=cfg.dropout,
                        training=training, gen=gen)
        sq = torch.sum(emb * emb, dim=-1, keepdim=True)
        # grad-safe norm: d sqrt(0) = inf would leak NaN through the pads;
        # the inner where keeps the unselected branch finite
        pos = sq > 0
        norm = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
        unit = emb / torch.maximum(norm, norm.new_full((), 1e-8))
        cocos = torch.einsum("bnd,bmd->bnm", unit, unit)
    return out, cocos


def _variances(std_vars: torch.Tensor, cfg: DivScorerConfig) -> torch.Tensor:
    if cfg.limit_delta is None:
        return torch.exp(std_vars)
    return torch.sigmoid(std_vars) * cfg.limit_delta


def div_forward(params, cfg: DivScorerConfig, q_repr, doc_reprs, mask,
                training=False, gen: Optional[torch.Generator] = None):
    """-> (mus [B, N], vars [B, N], cocos [B, N, N] or None).

    training=True with a generator `gen` (on the inputs' device) applies
    dropout where the JAX package does."""
    if cfg.cluster:
        start = gen.get_state() if (training and gen is not None) else None
        raws = []
        for k in range(cfg.K):
            if start is not None:
                gen.set_state(start)
            member = map_params(lambda t: t[k], params)
            raws.append(_single_raw_forward(member, cfg, q_repr, doc_reprs, mask,
                                            training, gen)[0])
        comps = torch.stack(raws, dim=-2)  # [B, N, K, 3]
        weights, mu_i, std_var_i = comps[..., 0], comps[..., 1], comps[..., 2]
        cocos = None
    else:
        raw, cocos = _single_raw_forward(params, cfg, q_repr, doc_reprs, mask, training, gen)
        if cfg.K == 1:
            return raw[..., 0], _variances(raw[..., 1], cfg), cocos
        comps = raw.reshape(*raw.shape[:-1], 3, cfg.K)  # split: weights, mus, std_vars
        weights, mu_i, std_var_i = comps[..., 0, :], comps[..., 1, :], comps[..., 2, :]
    coeff = torch.softmax(weights, dim=-1)
    mus = torch.sum(coeff * mu_i, dim=-1)
    vars_ = torch.sum(coeff * _variances(std_var_i, cfg), dim=-1)
    return mus, vars_, cocos


def expected_ranks(mus, vars_, mask, cocos=None):
    """Expected rank under Gaussian uncertainty, masked over real docs.
    Returns (ranks [B, N], phi0 [B, N, N], pairsub_mus, pairsub_vars)."""
    pairsub_mus = mus[..., :, None] - mus[..., None, :]
    if cocos is not None:
        std = torch.sqrt(vars_)
        pairsub_vars = (vars_[..., :, None] + vars_[..., None, :]
                        - cocos * std[..., :, None] * std[..., None, :])
    else:
        pairsub_vars = vars_[..., :, None] + vars_[..., None, :]
    pairsub_vars = torch.maximum(pairsub_vars, pairsub_vars.new_full((), 1e-8))
    phi0 = 0.5 * torch.special.erfc(pairsub_mus / torch.sqrt(2.0 * pairsub_vars))
    n = mus.shape[-1]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=mus.device)
    valid = (mask[..., :, None] & mask[..., None, :]) & offdiag
    ranks = torch.sum(torch.where(valid, phi0, 0.0), dim=-1) + 1.0
    return ranks, phi0, pairsub_mus, pairsub_vars


def div_predict(params, cfg: DivScorerConfig, q_repr, doc_reprs, mask):
    """Scores used for sorting at inference: ExpRele = mus; RERAR =
    1/E[rank]; RiskAware = mu - b*var."""
    mus, vars_, cocos = div_forward(params, cfg, q_repr, doc_reprs, mask)
    if cfg.sort_id == "ExpRele":
        return mus
    if cfg.sort_id == "RERAR":
        ranks, *_ = expected_ranks(mus, vars_, mask, cocos)
        return 1.0 / ranks
    if cfg.sort_id == "RiskAware":
        return mus - cfg.b * vars_
    raise NotImplementedError(cfg.sort_id)
