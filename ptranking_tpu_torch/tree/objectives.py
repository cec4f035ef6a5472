"""Custom GBDT objectives: numpy grad/hessian in LightGBM fobj form.

A copy of ptranking_tpu/tree/objectives.py (numpy on the host, the same
grad/hess bits): per query, vectorised over its pairs; the per-query loop
stays a Python loop, as in the JAX package. `weighting=True` applies the
DeltaNDCG / DeltaGain pair weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

FIRST_ORDER = False
CONSTANT_HESSIAN = 1.0
PAIR_TYPES = ["All", "NoTies", "No00", "00"]
WEIGHTING_TYPE = ["DeltaNDCG", "DeltaGain"]


def _sigmoid(x, epsilon=1.0):
    return 1.0 / (1.0 + np.exp(-np.clip(epsilon * x, -50, 50)))


def pair_mask_np(labels_sorted: np.ndarray, pair_type: str) -> np.ndarray:
    """Boolean [m, m] upper-triangular pair selection (reference triu_indice,
    lightgbm_util.py:17-60)."""
    m = len(labels_sorted)
    triu = np.triu(np.ones((m, m), bool), k=1)
    if pair_type == "All":
        return triu
    li, lj = labels_sorted[:, None], labels_sorted[None, :]
    if pair_type == "NoTies":
        return triu & (li != lj)
    if pair_type == "No00":
        return triu & ~((li == 0) & (lj == 0))
    if pair_type == "00":
        return triu & (li == 0) & (lj == 0)
    raise NotImplementedError(pair_type)


def ideal_dcg_np(ideally_sorted_labels: np.ndarray) -> float:
    gains = np.power(2.0, ideally_sorted_labels) - 1.0
    discounts = np.log2(np.arange(len(ideally_sorted_labels)) + 2.0)
    return float(np.sum(gains / discounts))


def delta_ndcg_np(ideally_sorted_labels, labels_sorted_via_preds) -> np.ndarray:
    idcg = max(ideal_dcg_np(ideally_sorted_labels), 1e-12)
    gains = np.power(2.0, labels_sorted_via_preds) - 1.0
    ng = gains / idcg
    dists = 1.0 / np.log2(np.arange(len(labels_sorted_via_preds)) + 2.0)
    return np.abs(ng[:, None] - ng[None, :]) * np.abs(dists[:, None] - dists[None, :])


def delta_gain_np(labels_sorted_via_preds) -> np.ndarray:
    gains = np.power(2.0, labels_sorted_via_preds) - 1.0
    return np.abs(gains[:, None] - gains[None, :])


def per_query_grad_hess_lambda(
    preds: np.ndarray,
    labels: np.ndarray,
    first_order: bool = False,
    weighting: bool = False,
    weighting_type: str = "DeltaNDCG",
    pair_type: str = "NoTies",
    epsilon: float = 1.0,
    symmetric_hessian: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Vectorised lambda gradients (reference
    per_query_gradient_hessian_lambda, lightgbm_util.py:120-177)."""
    desc = np.argsort(-preds, kind="stable")
    sp = preds[desc]
    sl = labels[desc]
    sel = pair_mask_np(sl, pair_type)

    s_ij = sp[:, None] - sp[None, :]
    big_s = np.clip(sl[:, None] - sl[None, :], -1.0, 1.0)
    sig = _sigmoid(s_ij, epsilon)
    lam = epsilon * (sig - 0.5 * (1.0 + big_s))
    if weighting:
        w = (delta_ndcg_np(np.sort(labels)[::-1], sl) if weighting_type == "DeltaNDCG"
             else delta_gain_np(sl))
        lam = lam * w
    lam = np.where(sel, lam, 0.0)
    grad_sorted = lam.sum(axis=1) - lam.sum(axis=0)  # +lambda_ij rows, -lambda_ij cols
    grad = np.zeros_like(preds)
    grad[desc] = grad_sorted
    if first_order:
        return grad, None
    h = np.maximum(epsilon * epsilon * _sigmoid(s_ij) * (1.0 - _sigmoid(s_ij)), 1e-16)
    if weighting:
        h = h * w
    h = np.where(sel, h, 0.0)
    if symmetric_hessian:
        # proper Newton hessian: +h to BOTH docs of a pair (Burges' LambdaMART;
        # what LightGBM's built-in lambdarank objective does)
        hess_sorted = h.sum(axis=1) + h.sum(axis=0)
    else:
        # reference adds +h to row doc and -h to col doc (lightgbm_util.py:168-172)
        hess_sorted = h.sum(axis=1) - h.sum(axis=0)
    hess = np.zeros_like(preds)
    hess[desc] = hess_sorted
    return grad, hess


def per_query_grad_hess_listnet(preds, labels) -> Tuple[np.ndarray, np.ndarray]:
    """Top-1 ListNet grad/hess (reference lightgbm_util.py:300-359):
    grad = softmax(preds) - softmax(labels); hess = p*(1-p)."""
    p = np.exp(preds - preds.max())
    p = p / p.sum()
    t = np.exp(labels - labels.max())
    t = t / t.sum()
    return p - t, np.maximum(p * (1.0 - p), 1e-16)


def _over_groups(fn, labels, preds, group):
    size = len(labels)
    grad = np.zeros(size)
    hess = (np.full(size, CONSTANT_HESSIAN) if FIRST_ORDER else np.zeros(size))
    head = 0
    for g in np.asarray(group).astype(int):
        gl, gp = labels[head:head + g], preds[head:head + g]
        gg, gh = fn(gp, gl)
        grad[head:head + g] = gg
        if gh is not None:
            hess[head:head + g] = gh
        head += g
    return grad, hess


def custom_obj_ranknet(labels, preds, group):
    return _over_groups(
        lambda p, l: per_query_grad_hess_lambda(p, l, first_order=FIRST_ORDER,
                                                pair_type="All", weighting=False),
        labels, preds, group)


def custom_obj_lambdarank(labels, preds, group):
    return _over_groups(
        lambda p, l: per_query_grad_hess_lambda(p, l, first_order=FIRST_ORDER,
                                                pair_type="NoTies", weighting=True,
                                                weighting_type="DeltaNDCG"),
        labels, preds, group)


def custom_obj_listnet(labels, preds, group):
    return _over_groups(lambda p, l: per_query_grad_hess_listnet(p, l), labels, preds, group)


# LightGBM fobj wrappers: (preds, train_data) -> (grad, hess)
def _fobj(core):
    def fobj(preds, train_data):
        return core(train_data.get_label(), preds, train_data.get_group())

    return fobj


custom_obj_ranknet_fobj = _fobj(custom_obj_ranknet)
custom_obj_lambdarank_fobj = _fobj(custom_obj_lambdarank)
custom_obj_listnet_fobj = _fobj(custom_obj_listnet)

def custom_obj_lambdarank_newton(labels, preds, group):
    """LambdaMART objective with the proper (all-positive) Newton hessian —
    used by the native GBDT (tree/gbdt.py), where leaves are Newton steps
    -G/(H+l2) and the reference fobj's signed hessian would break them."""
    return _over_groups(
        lambda p, l: per_query_grad_hess_lambda(p, l, first_order=False,
                                                pair_type="NoTies", weighting=True,
                                                weighting_type="DeltaNDCG",
                                                symmetric_hessian=True),
        labels, preds, group)


CUSTOM_OBJECTIVES = {
    "ranknet": (custom_obj_ranknet, custom_obj_ranknet_fobj),
    "lambdarank": (custom_obj_lambdarank, custom_obj_lambdarank_fobj),
    "lambdarank_newton": (custom_obj_lambdarank_newton, _fobj(custom_obj_lambdarank_newton)),
    "listnet": (custom_obj_listnet, custom_obj_listnet_fobj),
}
