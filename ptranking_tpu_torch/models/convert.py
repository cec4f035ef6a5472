"""Carry a JAX-package parameter tree and optimizer state over to the port.

The JAX package keeps scorer params as a nested dict/list pytree of arrays
(as `AdhocRanker.checkpoint()` stores them, numpy leaves), with `w` as
[d_in, d_out] for `x @ w`. The port keeps the same tree and layout, so the
conversion is leaf for leaf; it is checked against the tree that
`init_scorer(cfg)` builds, so a tree of another config is refused.

Its optimizer state is an optax state of NamedTuples, whose moment trees
mirror the params tree. A checkpoint reader that imports no optax keeps each
NamedTuple as a `JaxNamedTuple` (its class name and its fields in order);
`opt_state_from_jax` turns that into the port's optimizer state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ptranking_tpu_torch.models.scorers import ScorerConfig, init_scorer, tree_leaves
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


class JaxNamedTuple:
    """Stand-in for a class of optax or jax in a JAX checkpoint. NamedTuples
    unpickle as `cls.__new__(cls, *fields)`, so this keeps the fields in
    order as `args`; the subclass made for each pickled class keeps its name."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        pass


# optax core states of the chain's rule (ptranking_tpu/train/optimizer.py):
# field names in order, and the port's optimizer that takes each
_OPTAX_CORES = {
    "ScaleByRssState": ("Adagrad", ("sum_of_squares",)),
    "ScaleByAdamState": ("Adam", ("count", "mu", "nu")),
    "ScaleByRmsState": ("RMS", ("nu",)),
}


def opt_state_from_jax(opt_state: JaxNamedTuple, cfg: ScorerConfig, opt: str,
                       device="cpu") -> Dict[str, Any]:
    """The JAX package's optax state (inject_hyperparams over the chain
    weight decay -> rule -> scale -> lr) as the port's optimizer state:
    {"lr": the injected learning rate, "state": {param index: state}} with
    params indexed in `tree_leaves` order. Adagrad's sum_of_squares becomes
    "sum", RMS's nu "nu", Adam's count, mu, nu torch.optim.Adam's "step",
    "exp_avg", "exp_avg_sq"."""
    _count, hyperparams, _hyper_states, inner = opt_state.args
    cores = [s for s in inner if type(s).__name__ in _OPTAX_CORES]
    if len(cores) != 1:
        raise ValueError(f"expected one optax rule state in the chain, got "
                         f"{[type(s).__name__ for s in inner]}")
    core = cores[0]
    want_opt, names = _OPTAX_CORES[type(core).__name__]
    if want_opt != opt:
        raise ValueError(f"the checkpoint's optimizer state is {want_opt}'s, not {opt}'s")
    fields = dict(zip(names, core.args))
    ref = init_scorer(cfg, device="meta")

    def leaves(name):
        return tree_leaves(_convert(fields[name], ref, name, device))

    if opt == "Adagrad":
        per = [{"sum": t} for t in leaves("sum_of_squares")]
    elif opt == "RMS":
        per = [{"nu": t} for t in leaves("nu")]
    else:
        step = torch.tensor(float(np.asarray(fields["count"])), dtype=torch.float32)
        per = [{"step": step.clone(), "exp_avg": mu, "exp_avg_sq": nu}
               for mu, nu in zip(leaves("mu"), leaves("nu"))]
    return {"lr": float(np.asarray(hyperparams["learning_rate"])), "state": dict(enumerate(per))}
