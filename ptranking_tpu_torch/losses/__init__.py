"""The LTR loss registry, as in ptranking_tpu/losses/__init__.py: losses are
pure `f(scores, labels, mask, **hyper) -> scalar`, and a model id names one.

`LOSSES` holds all 14 model ids of the JAX package, with its
`DEFAULT_PARAS`, `STOCHASTIC` and `REQUIRES_LISTSF`. A loss whose id is in
`STOCHASTIC` takes its random draws from `gen=` (a torch.Generator) or, in
their place, `noise=` (the uniform draws themselves). `get_loss` of an
unknown id raises a KeyError that lists the known ones.
"""

from typing import Any, Callable, Dict

from ptranking_tpu_torch.losses.listwise import (
    approx_ndcg,
    lambda_loss,
    lambda_rank,
    listmle,
    listnet,
    mdp_rank,
    neural_ndcg,
    rank_cosine,
    soft_rank,
    st_listnet,
)
from ptranking_tpu_torch.losses.pairwise import ranknet
from ptranking_tpu_torch.losses.pointwise import rank_mse
from ptranking_tpu_torch.losses.wassrank import wass_rank

LossFn = Callable[..., Any]

LOSSES: Dict[str, LossFn] = {
    "RankMSE": rank_mse,
    "RankNet": ranknet,
    "LambdaRank": lambda_rank,
    "ListNet": listnet,
    "STListNet": st_listnet,
    "ListMLE": listmle,
    "RankCosine": rank_cosine,
    "ApproxNDCG": approx_ndcg,
    "LambdaLoss": lambda_loss,
    "SoftRank": soft_rank,
    "MDPRank": mdp_rank,
    "WassRank": wass_rank,
    "DASALC": listnet,  # ListNet loss on the DASALC listwise scorer
    "NeuralNDCG": neural_ndcg,
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
        raise KeyError(f"unknown model id {model_id!r}; implemented: {sorted(LOSSES)}") from None


__all__ = ["LOSSES", "DEFAULT_PARAS", "STOCHASTIC", "REQUIRES_LISTSF", "get_loss"]
