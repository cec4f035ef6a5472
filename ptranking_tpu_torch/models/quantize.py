"""Int8 weight quantization for serving.

Counterpart of ptranking_tpu/models/quantize.py, with the same scheme and the
same numpy float32 arithmetic, so `w_q` and `w_s` match the JAX package's bit
for bit:
  * weights: a scale per output channel, s_c = max(max|w[:, c]| / 127, 1e-12),
    w_q = clip(rint(w / s_c), -127, 127) as int8;
  * activations: a scale per token, computed at run time in
    models/scorers/nn.py::linear_apply, x_q = round(x / a_t) as int8;
  * y = (x_q @ w_q) accumulated in int32, times (a_t * s_c), plus b, in fp32.

On the card the int8 product runs on the int8 tensor cores (twice the bf16
peak of an H100), and the weights are a quarter of their fp32 bytes.
`quantize_scorer_params` rewrites every linear {"w", "b"} of a scorer's
params to {"w_q", "w_s", "b"}; linear_apply dispatches on the keys. The
attention's own products stay floating point. Quantized params are for
inference only (rounding has no gradient): AdhocRanker.quantized() makes the
inference-only copy and training it raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def quantize_linear(p: dict) -> dict:
    """{"w": [d_in, d_out], "b"} -> {"w_q" int8, "w_s" fp32 [d_out], "b" fp32},
    on w's device."""
    device = p["w"].device if isinstance(p["w"], torch.Tensor) else "cpu"
    w = _to_numpy(p["w"])
    s = np.max(np.abs(w), axis=0) / np.float32(127.0)
    s = np.maximum(s, np.float32(1e-12))  # an all-zero channel keeps a finite scale
    w_q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return {"w_q": torch.from_numpy(w_q).to(device),
            "w_s": torch.from_numpy(s.astype(np.float32)).to(device),
            "b": torch.from_numpy(_to_numpy(p["b"])).to(device)}


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def is_quantized(params: Any) -> bool:
    """True when any linear of the tree holds int8 weights."""
    if isinstance(params, dict):
        return "w_q" in params or any(is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(is_quantized(v) for v in params)
    return False


def quantize_scorer_params(params: Any) -> Any:
    """Every linear ({"w", "b"} dict) in its int8 form; norms and anything
    else pass through untouched."""
    if isinstance(params, dict):
        if set(params) == {"w", "b"}:
            return quantize_linear(params)
        return {k: quantize_scorer_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_scorer_params(v) for v in params)
    return params
