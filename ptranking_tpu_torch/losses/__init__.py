"""The LTR loss registry, as in ptranking_tpu/losses/__init__.py: losses are
pure `f(scores, labels, mask, **hyper) -> scalar`, and a model id names one.

`LOSSES` holds the losses ported so far; `DEFAULT_PARAS`, `STOCHASTIC` and
`REQUIRES_LISTSF` are the JAX package's, whole, so a checkpoint of any model
id keeps its hyper-parameters. `get_loss` of an id the JAX package has but
the port does not yet raises a KeyError that says so.
"""

from typing import Any, Callable, Dict

from ptranking_tpu_torch.losses.listwise import lambda_rank, listnet
from ptranking_tpu_torch.losses.pairwise import ranknet
from ptranking_tpu_torch.losses.pointwise import rank_mse

LossFn = Callable[..., Any]

LOSSES: Dict[str, LossFn] = {
    "RankMSE": rank_mse,
    "RankNet": ranknet,
    "LambdaRank": lambda_rank,
    "ListNet": listnet,
    "DASALC": listnet,  # ListNet loss on the DASALC listwise scorer
}

# Per-model default hyper-parameters (the reference's default_para_dict).
DEFAULT_PARAS: Dict[str, Dict[str, Any]] = {
    "RankMSE": {},
    "RankNet": {"sigma": 1.0},
    "LambdaRank": {"sigma": 1.0},
    "ListNet": {},
    "STListNet": {"temperature": 1.0},
    "ListMLE": {},
    "RankCosine": {},
    "ApproxNDCG": {"alpha": 10.0},
    "LambdaLoss": {"loss_type": "NDCG_Loss2", "k": 5, "sigma": 1.0, "mu": 5.0},
    "SoftRank": {"delta": 2.0, "top_k": None},
    "MDPRank": {"distribution": "PL", "temperature": 1.0, "gamma": 1.0, "top_k": 10},
    "WassRank": {
        "mode": "SinkhornOT", "sh_itr": 20, "lam": 0.1, "smooth_type": "ST",
        "norm_type": "BothST", "cost_type": "eg", "non_rele_gap": 100.0,
        "var_penalty": 2.718281828459045, "gain_base": 4.0,
    },
    "DASALC": {},
    "NeuralNDCG": {"temperature": 1.0, "top_k": None, "sinkhorn_iters": 10},
}

# Models whose loss consumes random draws every step.
STOCHASTIC = {"STListNet", "ListMLE", "MDPRank"}

# Models that require the listwise (self-attention) scorer.
REQUIRES_LISTSF = {"DASALC"}


def get_loss(model_id: str) -> LossFn:
    try:
        return LOSSES[model_id]
    except KeyError:
        if model_id in DEFAULT_PARAS:
            raise KeyError(f"model id {model_id!r} is not ported yet; ported: "
                           f"{sorted(LOSSES)}") from None
        raise KeyError(f"unknown model id {model_id!r}; ported: {sorted(LOSSES)}") from None


__all__ = ["LOSSES", "DEFAULT_PARAS", "STOCHASTIC", "REQUIRES_LISTSF", "get_loss"]
