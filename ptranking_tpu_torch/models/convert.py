"""Carry a JAX-package parameter tree over to the port.

The JAX package keeps scorer params as a nested dict/list pytree of arrays
(as `AdhocRanker.checkpoint()` stores them, numpy leaves), with `w` as
[d_in, d_out] for `x @ w`. The port keeps the same tree and layout, so the
conversion is leaf for leaf; it is checked against the tree that
`init_scorer(cfg)` builds, so a tree of another config is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ptranking_tpu_torch.models.scorers import ScorerConfig, init_scorer
from ptranking_tpu_torch.models.scorers.nn import Params


def _convert(src, ref, path: str, device):
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'params'}: expected keys {sorted(ref)}, got {got}")
        return {k: _convert(src[k], ref[k], f"{path}.{k}" if path else k, device)
                for k in ref}
    if isinstance(ref, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)} entries")
        return [_convert(s, r, f"{path}[{i}]", device) for i, (s, r) in enumerate(zip(src, ref))]
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{path}: expected shape {tuple(ref.shape)}, got {arr.shape}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def params_from_jax(np_tree, cfg: ScorerConfig, device="cpu") -> Params:
    """JAX scorer params (numpy leaves) -> the port's params, fp32 on `device`."""
    return _convert(np_tree, init_scorer(cfg, device="meta"), "", device)
