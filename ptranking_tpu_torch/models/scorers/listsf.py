"""Listwise (permutation-equivariant) scorer: MHSA encoder layers, eval form.

Counterpart of ptranking_tpu/models/scorers/listsf.py with the three encoder
wirings (AllRank pre-norm residual, DASALC post-norm latent cross, AttnDIN
post-norm residual). Attention logits are masked on the key axis so padded
documents get no weight, and QKV is one fused [F, 3F] projection split q|k|v
and then into heads.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.models.scorers.nn import (
    Params,
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
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
               attn_block_size: Optional[int] = None, flash: bool = False) -> torch.Tensor:
    """Masked multi-head self-attention over the document axis.
    x: [B, N, F]; mask: [B, N]."""
    B, N, F = x.shape
    d_head = F // n_heads
    qkv = linear_apply(p["qkv"], x)  # [B, N, 3F]
    q, k, v = torch.split(qkv, F, dim=-1)

    def heads(t):  # [B, N, F] -> [B, H, N, d]
        return t.reshape(B, N, n_heads, d_head).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if flash:
        out = flash_attention(q, k, v, mask)
    elif attn_block_size is not None and N > attn_block_size:
        out = blockwise_attention(q, k, v, mask, block_size=attn_block_size)
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.sqrt(torch.tensor(float(d_head)))
        logits = torch.where(mask[:, None, None, :], logits, PAD_SCORE)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)  # softmax in fp32
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, N, F)
    return linear_apply(p["fc"], out)


def pff_init(gen: torch.Generator, num_features: int, hid_dim: int, device="cpu") -> Params:
    return {"w1": linear_init(gen, num_features, hid_dim, device),
            "w2": linear_init(gen, hid_dim, num_features, device)}


def pff_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Position-wise FFN: linear -> ReLU -> linear."""
    return linear_apply(p["w2"], torch.relu(linear_apply(p["w1"], x)))


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


def encoder_apply(p: Params, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
                  encoder_type: str, attn_block_size: Optional[int] = None,
                  flash: bool = False) -> torch.Tensor:
    """Encoder wiring per variant:

      AllRank: x + MHSA(LN(x)); x + FC(LN(x)); final LN
      DASALC:  LN(MHSA(x))
      AttnDIN: LN(x + MHSA(x))
    """
    for layer in p["layers"]:
        if encoder_type == "AllRank":
            h = mhsa_apply(layer["mhsa"], layer_norm_apply(layer["ln1"], x), mask,
                           n_heads, attn_block_size, flash)
            x = x + h
            x = x + pff_apply(layer["fc"], layer_norm_apply(layer["ln2"], x))
        elif encoder_type == "DASALC":
            h = mhsa_apply(layer["mhsa"], x, mask, n_heads, attn_block_size, flash)
            x = layer_norm_apply(layer["ln"], h)
        elif encoder_type == "AttnDIN":
            h = mhsa_apply(layer["mhsa"], x, mask, n_heads, attn_block_size, flash)
            x = layer_norm_apply(layer["ln"], x + h)
        else:
            raise NotImplementedError(encoder_type)
    if encoder_type == "AllRank" and "final_ln" in p:
        x = layer_norm_apply(p["final_ln"], x)
    return x
