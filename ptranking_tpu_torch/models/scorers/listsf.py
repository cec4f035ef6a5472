"""Listwise (permutation-equivariant) scorer: MHSA encoder layers.

Counterpart of ptranking_tpu/models/scorers/listsf.py with the three encoder
wirings (AllRank pre-norm residual, DASALC post-norm latent cross, AttnDIN
post-norm residual). Attention logits are masked on the key axis so padded
documents get no weight, and QKV is one fused [F, 3F] projection split q|k|v
and then into heads.

Under context parallelism (a parallel/ring.py::CPPlan `cp`) x holds the
rank's block of each list's docs and the attention runs through the ring or
Ulysses exchange over the `seq` axis, as in the JAX package; it has no
attention dropout, flash is off and attn_block_size is ignored.

Training form, as in the JAX package: attention-probability dropout on the
dense and the blockwise (attn_block_size) paths (the flash path has none),
AllRank's residual and position-wise FFN dropouts, and `remat` (each layer
recomputed in the backward pass, through torch.utils.checkpoint). Dropout
masks come from an explicit torch.Generator; a rematerialised layer replays
its own masks (see `_remat_layer`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.models.scorers.nn import (
    Params,
    dropout,
    layer_norm_apply,
    layer_norm_init,
    column_split,
    linear_apply,
    linear_init,
    row_linear,
    tp_linear,
)
from ptranking_tpu_torch.ops.attention import blockwise_attention, flash_attention


def mhsa_init(gen: torch.Generator, hid_dim: int, device="cpu") -> Params:
    std = math.sqrt(2.0 / (hid_dim + hid_dim))  # xavier per-projection fan
    w = std * torch.randn(hid_dim, 3 * hid_dim, generator=gen, device=gen.device)
    return {
        "qkv": {"w": w.to(device), "b": torch.zeros(3 * hid_dim, device=device)},
        "fc": linear_init(gen, hid_dim, hid_dim, device),
    }


def mhsa_apply(p: Params, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
               attn_block_size: Optional[int] = None, flash: bool = False,
               drop_rate: float = 0.1, training: bool = False,
               gen: Optional[torch.Generator] = None, tp=None, cp=None) -> torch.Tensor:
    """Masked multi-head self-attention over the document axis.
    x: [B, N, F]; mask: [B, N]. In training, the dense and blockwise paths
    drop attention probabilities; the flash path drops none (as in the JAX
    package). Under a CPPlan `cp`, x and mask are the rank's block of the
    docs and the attention is parallel/ring.py::cp_attention (no dropout).

    Under a ModelParallel share `tp` whose spec splits `qkv` (M = tp.degree
    ranks, n_heads % M == 0) the rank runs heads [r H/M, (r+1) H/M): p["qkv"]
    holds q, k and v of those heads (Split(qkv=True)), the attention runs on
    [B, H/M, N, d], attention dropout draws for all heads and keeps the
    rank's, and `fc` is row-parallel (its partial sums reduced over `model`
    before the whole bias)."""
    B, N, F = x.shape
    d_head = F // n_heads
    split = tp is not None and tp.degree > 1 and tp.spec["qkv"]["w"] is not None
    h_split = None
    if split:
        x = tp.copy(x)
        h_start, n_heads = tp.block(n_heads)
        h_split = (n_heads * tp.degree, h_start)
        F = n_heads * d_head
    qkv = linear_apply(p["qkv"], x)  # [B, N, 3F]
    q, k, v = torch.split(qkv, F, dim=-1)

    def heads(t):  # [B, N, F] -> [B, H, N, d]
        return t.reshape(B, N, n_heads, d_head).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if cp is not None:
        from ptranking_tpu_torch.parallel.ring import cp_attention

        out = cp_attention(q, k, v, mask, cp)
    elif flash:
        out = flash_attention(q, k, v, mask)
    elif attn_block_size is not None and N > attn_block_size:
        # attention dropout inside the blocks, the dense form exactly
        out = blockwise_attention(q, k, v, mask, block_size=attn_block_size,
                                  drop_rate=drop_rate if training else 0.0,
                                  gen=gen if training else None, heads=h_split)
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.sqrt(torch.tensor(float(d_head)))
        logits = torch.where(mask[:, None, None, :], logits, PAD_SCORE)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)  # softmax in fp32
        attn = dropout(gen, attn, drop_rate, training,
                       None if h_split is None else (1, *h_split))
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, N, F)
    if split:
        return row_linear(p["fc"], out, tp)
    return linear_apply(p["fc"], out)


def pff_init(gen: torch.Generator, num_features: int, hid_dim: int, device="cpu") -> Params:
    return {"w1": linear_init(gen, num_features, hid_dim, device),
            "w2": linear_init(gen, hid_dim, num_features, device)}


def pff_apply(p: Params, x: torch.Tensor, drop_rate: float = 0.1, training: bool = False,
              gen: Optional[torch.Generator] = None, tp=None) -> torch.Tensor:
    """Position-wise FFN: linear -> ReLU -> [dropout] -> linear. Under a
    ModelParallel share `tp`, w1 and w2 run by their Splits (column then
    row; tp_linear) and dropout keeps the rank's block of a full draw."""
    if tp is None or not tp.splits_any():
        h = torch.relu(linear_apply(p["w1"], x))
        return linear_apply(p["w2"], dropout(gen, h, drop_rate, training))
    h, split = tp_linear(p["w1"], x, False, tp, tp.spec["w1"]["w"])
    h = dropout(gen, torch.relu(h), drop_rate, training, column_split(h, tp) if split else None)
    return tp_linear(p["w2"], h, split, tp, tp.spec["w2"]["w"])[0]


def encoder_init(gen: torch.Generator, num_features: int, n_layers: int,
                 encoder_type: str, device="cpu") -> Params:
    """L encoder layers, each with its own init."""
    layers = []
    for _ in range(n_layers):
        layer: Dict[str, Params] = {"mhsa": mhsa_init(gen, num_features, device)}
        if encoder_type == "AllRank":
            layer["fc"] = pff_init(gen, num_features, num_features, device)
            layer["ln1"] = layer_norm_init(num_features, device)
            layer["ln2"] = layer_norm_init(num_features, device)
        else:  # DASALC / AttnDIN: single post-norm sublayer
            layer["ln"] = layer_norm_init(num_features, device)
        layers.append(layer)
    enc: Params = {"layers": layers}
    if encoder_type == "AllRank":
        enc["final_ln"] = layer_norm_init(num_features, device)
    return enc


def _remat_layer(fn: Callable, layer: Params, x: torch.Tensor,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """`fn(layer, x, gen)` under torch.utils.checkpoint. The checkpoint's own
    RNG handling restores only the default generators, so with an explicit
    one the recompute would draw other dropout masks and give wrong
    gradients. Instead the layer draws from a generator of its own, started
    from `gen`'s state; the recompute starts another from the same state and
    replays the same masks, and `gen` continues from where the layer ended."""
    if gen is None:
        return checkpoint(lambda h: fn(layer, h, None), x, use_reentrant=False)
    start = gen.get_state()
    end = {}

    def run(h):
        g = torch.Generator(device=gen.device)
        g.set_state(start)
        out = fn(layer, h, g)
        end["state"] = g.get_state()
        return out

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    gen.set_state(end["state"])
    return out


def encoder_apply(p: Params, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
                  encoder_type: str, attn_block_size: Optional[int] = None,
                  flash: bool = False, drop_rate: float = 0.1, training: bool = False,
                  gen: Optional[torch.Generator] = None, remat: bool = False,
                  tp=None, cp=None) -> torch.Tensor:
    """Encoder wiring per variant:

      AllRank: x + drop(MHSA(LN(x))); x + drop(FC(LN(x))); final LN
      DASALC:  LN(MHSA(x))
      AttnDIN: LN(x + MHSA(x))

    remat recomputes each layer in the backward pass (when a gradient is
    being taken) instead of keeping its activations; under a ModelParallel
    share `tp` (the encoder's spec) the recompute replays the layer's
    `model` collectives, in the same order on every rank (and under a
    CPPlan `cp` its `seq` collectives). Each sublayer's output is whole, so
    the norms and residuals run on whole tensors."""

    def one_layer(i, layer, x, g):
        share = None if tp is None else tp.at("layers", i)

        def attend(h):
            return mhsa_apply(layer["mhsa"], h, mask, n_heads, attn_block_size, flash,
                              drop_rate, training, g, share and share.at("mhsa"), cp)

        if encoder_type == "AllRank":
            x = x + dropout(g, attend(layer_norm_apply(layer["ln1"], x)), drop_rate, training)
            h = pff_apply(layer["fc"], layer_norm_apply(layer["ln2"], x), drop_rate, training, g,
                          share and share.at("fc"))
            return x + dropout(g, h, drop_rate, training)
        if encoder_type == "DASALC":
            return layer_norm_apply(layer["ln"], attend(x))
        if encoder_type == "AttnDIN":
            return layer_norm_apply(layer["ln"], x + attend(x))
        raise NotImplementedError(encoder_type)

    for i, layer in enumerate(p["layers"]):
        fn = functools.partial(one_layer, i)
        if remat and torch.is_grad_enabled():
            x = _remat_layer(fn, layer, x, gen)
        else:
            x = fn(layer, x, gen)
    if encoder_type == "AllRank" and "final_ln" in p:
        x = layer_norm_apply(p["final_ln"], x)
    return x
