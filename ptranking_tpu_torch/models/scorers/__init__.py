"""Scorer configuration, seeded init and the scorer (pointsf, listsf).

Counterpart of ptranking_tpu/models/scorers/__init__.py. A scorer is a pair
of plain functions over a nested dict of tensors:
`init_scorer(cfg, seed, device) -> params` and
`apply_scorer(params, cfg, x, mask, training=False, gen=None) -> scores [B, N]` (fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ptranking_tpu_torch import LTR_SEED
from ptranking_tpu_torch.models.scorers import listsf as _listsf
from ptranking_tpu_torch.models.scorers.nn import Params, ffn_apply, ffn_init


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    """Hyper-parameters of the scoring function; the same fields and defaults
    as the JAX package's ScorerConfig, so its pickled configs load as this
    class. `remat` and `dropout` only matter for training."""

    sf_id: str = "pointsf"  # 'pointsf' | 'listsf'
    num_features: int = 46
    # --- pointsf ---
    h_dim: int = 100
    out_dim: int = 1
    num_layers: int = 5
    # --- shared FFN knobs ---
    AF: str = "GE"
    TL_AF: str = "S"
    apply_tl_af: bool = True
    BN: bool = True
    bn_type: str = "BN"  # 'BN' (cross-batch stats) | 'BN2' (per-query stats)
    bn_affine: bool = True
    dropout: float = 0.1
    # --- listsf ---
    ff_dims: Tuple[int, ...] = (128, 256, 512)
    n_heads: int = 2
    encoder_layers: int = 6
    encoder_type: str = "DASALC"  # DASALC | AllRank | AttnDIN
    # 'bfloat16' casts params and activations for the scorer compute; norm
    # statistics, attention logits and the scores stay fp32
    compute_dtype: str = "float32"
    remat: bool = False
    # blockwise attention above this list length (None = dense)
    attn_block_size: Optional[int] = None
    # the MHSA runs through ops.attention.flash_attention (the CUDA kernel
    # on the card); overrides attn_block_size
    flash_attn: bool = False
    # listsf only: round the working width up to a multiple of 128; features
    # are zero-padded once at entry (a model variant with more params)
    lane_align: bool = False

    @property
    def bn_per_query(self) -> bool:
        return self.bn_type == "BN2"

    @property
    def width(self) -> int:
        """The trunk working width: num_features, rounded up to a multiple of
        128 under lane_align."""
        if self.lane_align and self.sf_id.startswith("listsf"):
            return ((self.num_features + 127) // 128) * 128
        return self.num_features

    @staticmethod
    def default_pointsf(num_features: int, **overrides) -> "ScorerConfig":
        return ScorerConfig(sf_id="pointsf", num_features=num_features, **overrides)

    @staticmethod
    def default_listsf(num_features: int, **overrides) -> "ScorerConfig":
        base = dict(
            sf_id="listsf",
            num_features=num_features,
            AF="R",
            TL_AF="GE",
            apply_tl_af=False,
            BN=False,
            bn_type="BN2",
            bn_affine=False,
            ff_dims=(128, 256, 512),
            n_heads=2,
            encoder_layers=6,
            encoder_type="DASALC",
        )
        base.update(overrides)
        return ScorerConfig(**base)


def init_scorer(cfg: ScorerConfig, seed: int = LTR_SEED, device="cpu") -> Params:
    """Fresh fp32 params, drawn from a CPU torch.Generator seeded with `seed`
    (so one seed gives the same params on every device), placed on `device`."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if cfg.sf_id.startswith("pointsf"):
        ff_dims = [cfg.num_features] + [cfg.h_dim] * cfg.num_layers + [cfg.out_dim]
        return {"point_sf": ffn_init(gen, ff_dims, BN=cfg.BN, bn_affine=cfg.bn_affine,
                                     apply_tl_af=cfg.apply_tl_af, device=device)}
    if cfg.sf_id.startswith("listsf"):
        F = cfg.width
        return {
            # the head FFN always ends with BN + AF (apply_tl_af with TL_AF=AF)
            "head_ffnns": ffn_init(gen, [F, *cfg.ff_dims, F], BN=cfg.BN,
                                   bn_affine=cfg.bn_affine, apply_tl_af=True, device=device),
            "encoder": _listsf.encoder_init(gen, F, cfg.encoder_layers, cfg.encoder_type, device),
            "tail_ffnns": ffn_init(gen, [F, *cfg.ff_dims, cfg.out_dim], BN=cfg.BN,
                                   bn_affine=cfg.bn_affine, apply_tl_af=cfg.apply_tl_af,
                                   device=device),
        }
    raise NotImplementedError(cfg.sf_id)


def map_params(fn, params):
    """Apply `fn` to every tensor of a nested dict/list parameter tree."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(fn, v) for v in params]
    return fn(params)


def tree_leaves(params) -> list:
    """The tensors of a nested dict/list parameter tree, in the tree's order
    (the order `init_scorer` builds and `map_params` walks)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in tree_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in tree_leaves(v)]
    return [params]


def apply_scorer(params: Params, cfg: ScorerConfig, x: torch.Tensor, mask: torch.Tensor,
                 training: bool = False, gen: Optional[torch.Generator] = None,
                 tp=None, pp=None, cp=None) -> torch.Tensor:
    """Score a padded batch: [B, N, F] -> [B, N] in fp32 (fp64 stays fp64).
    Padded docs score garbage by design — consumers apply `mask`.

    training=True with a generator `gen` (on x's device) applies dropout at
    rate cfg.dropout where the JAX package does. The params stay as given
    (fp32 masters in training); the bf16 cast of compute_dtype happens here,
    so gradients reach the fp32 masters.

    `tp` (parallel/tensor.py::ModelParallel with the params' spec) runs the
    params as a tensor-parallel rank's shards, as the JAX package's
    shardings do. `pp` (parallel/pipeline.py::PPPlan) stages the listsf
    encoder as a GPipe pipeline over the mesh's `model` axis when
    training=False; the head and tail FFNs run on the whole batch, since
    their batch norm takes the batch's statistics. `cp`
    (parallel/ring.py::CPPlan) says x and mask are the rank's block of the
    docs: the listsf's attention runs through the plan's ring or Ulysses
    exchange over `seq`, without flash. Where both are given, the pipeline
    takes inference and CP training, as in the JAX package."""
    out_dtype = torch.promote_types(x.dtype, torch.float32)
    if cfg.compute_dtype == "bfloat16":
        params = map_params(
            lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a, params)
        x = x.to(torch.bfloat16)

    if cfg.sf_id.startswith("pointsf"):
        out = ffn_apply(params["point_sf"], x, mask, AF=cfg.AF, TL_AF=cfg.TL_AF,
                        apply_tl_af=cfg.apply_tl_af, BN=cfg.BN,
                        bn_per_query=cfg.bn_per_query, drop_rate=cfg.dropout,
                        training=training, gen=gen, tp=tp and tp.at("point_sf"))
        return out[..., 0].to(out_dtype)

    if cfg.sf_id.startswith("listsf"):
        if cfg.width != x.shape[-1]:  # lane_align: zero-pad the features once
            x = torch.nn.functional.pad(x, (0, cfg.width - x.shape[-1]))

        def head(v):
            return ffn_apply(params["head_ffnns"], v, mask, AF=cfg.AF, TL_AF=cfg.AF,
                             apply_tl_af=True, BN=cfg.BN, bn_per_query=cfg.bn_per_query,
                             drop_rate=cfg.dropout, training=training, gen=gen,
                             tp=tp and tp.at("head_ffnns"))

        def encode(v):
            if pp is not None and not training:
                from ptranking_tpu_torch.parallel.pipeline import pipeline_encoder_apply

                return pipeline_encoder_apply(params["encoder"], v, mask, cfg.n_heads,
                                              cfg.encoder_type, pp.mesh,
                                              num_microbatches=pp.num_microbatches,
                                              axis_name=pp.axis_name,
                                              attn_block_size=cfg.attn_block_size,
                                              flash=cfg.flash_attn)
            return _listsf.encoder_apply(params["encoder"], v, mask, cfg.n_heads,
                                         cfg.encoder_type, cfg.attn_block_size,
                                         cfg.flash_attn and cp is None, cfg.dropout, training,
                                         gen, cfg.remat, tp=tp and tp.at("encoder"), cp=cp)

        if cfg.encoder_type == "AllRank":
            combined = encode(head(x))
        elif cfg.encoder_type == "DASALC":
            combined = (encode(x) + 1.0) * head(x)  # latent cross
        elif cfg.encoder_type == "AttnDIN":
            combined = encode(head(x)) + x  # residual to raw features
        else:
            raise NotImplementedError(cfg.encoder_type)
        out = ffn_apply(params["tail_ffnns"], combined, mask, AF=cfg.AF, TL_AF=cfg.TL_AF,
                        apply_tl_af=cfg.apply_tl_af, BN=cfg.BN,
                        bn_per_query=cfg.bn_per_query, drop_rate=cfg.dropout,
                        training=training, gen=gen, tp=tp and tp.at("tail_ffnns"))
        return out[..., 0].to(out_dtype)

    raise NotImplementedError(cfg.sf_id)
