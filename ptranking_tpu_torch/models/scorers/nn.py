"""Neural-net building blocks over plain dicts of tensors: activations, linear
layers, masked batch norm, LayerNorm, dropout and the stacked FFN.

Counterpart of ptranking_tpu/models/scorers/nn.py. Parameters keep the JAX
package's layout (`w` is [d_in, d_out] for `x @ w`), so a JAX parameter tree
carries over leaf for leaf. The reference choices kept here:

  * a linear layer accumulates in fp32 (bias added in fp32) and returns in
    the activation dtype: on CUDA in bf16 a bf16 x bf16 product with fp32
    accumulation, elsewhere an fp32 product of upcast operands (exact for
    bf16 values);
  * BN statistics are fp32 over real documents only, and padded rows come out 0;
  * LayerNorm divides by the UNBIASED std plus eps (not `nn.LayerNorm`);
  * "GE" is the tanh form of GELU (jax.nn.gelu's default);
  * dropout draws its keep-mask from an explicit torch.Generator (the JAX
    package's explicit PRNG keys), so a run is reproducible from its seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ptranking_tpu_torch.parallel.collectives import batch_rand, global_sum, query_sum

Params = Dict[str, object]

_BN_EPS = 1e-5
_LN_EPS = 1e-6


def _rrelu(x):  # eval-mode RReLU == LeakyReLU with the mean slope (1/8+1/3)/2
    return torch.where(x >= 0, x, x * ((1.0 / 8.0 + 1.0 / 3.0) / 2.0))


_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "R": F.relu,
    "LR": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "RR": _rrelu,
    "E": F.elu,
    "SE": F.selu,
    "CE": F.celu,
    "GE": lambda x: F.gelu(x, approximate="tanh"),
    "S": torch.sigmoid,
    "SW": F.silu,
    "T": torch.tanh,
    "ST": lambda x: torch.softmax(x, dim=-1),
}


def get_af(af_str: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by short string id."""
    try:
        return _ACTIVATIONS[af_str]
    except KeyError:
        raise NotImplementedError(f"unknown activation id {af_str!r}")


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                device="cpu") -> Params:
    """Xavier-normal weights [d_in, d_out], zero bias."""
    std = math.sqrt(2.0 / (d_in + d_out))
    w = std * torch.randn(d_in, d_out, generator=gen, device=gen.device)
    return {"w": w.to(device), "b": torch.zeros(d_out, device=device)}


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result for bf16 operands on
    CUDA: `aten::mm.dtype`, which this build of torch has only for CUDA. Its
    result type is fp32, so cuBLAS accumulates and reduces (split-K included)
    in fp32: `allow_bf16_reduced_precision_reduction` concerns bf16 results
    only and is left as it is. No fallback: a torch without the overload
    raises here."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _Bf16Linear(torch.autograd.Function):
    """y = bf16(x @ w + b) for bf16 x, w, b on CUDA: the product on the bf16
    tensor cores with fp32 accumulation, the bias added in fp32, one rounding
    to bf16, as the JAX package's `jnp.dot(x, w, preferred_element_type=f32)
    + b` (models/scorers/nn.py:93). The dtype overload has no autograd, so
    the backward is written out as JAX's transpose computes it: dx and dw as
    bf16 x bf16 products with fp32 accumulation, each rounded once to bf16,
    db the fp32 sum of dy in b's dtype."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        ctx.b_dtype = b.dtype
        return _mm_f32(x2, w).add_(b).to(x2.dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx = _mm_f32(dy, w.t()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(x2.t(), dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = dy.float().sum(0).to(ctx.b_dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def _takes_bf16_gemm(x: torch.Tensor, p: Params) -> bool:
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and p["w"].dtype == torch.bfloat16 and p["b"].dtype == torch.bfloat16)


# torch._int_mm's shape conditions on CUDA: the inner and output dims a
# multiple of 8, more than 16 rows (INT8_MIN_ROWS); smaller operands are
# zero-padded, which leaves the int32 sums exact
INT8_DIM_MULTIPLE = 8
INT8_MIN_ROWS = 17


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact. CUDA: `torch._int_mm`
    (cuBLASLt's int8 tensor-core GEMM; the JAX package leaves this product to
    XLA, outside any Pallas kernel), the operands zero-padded to its shape
    conditions and the result sliced back; no other route on the card, so a
    torch that refuses the product raises. CPU: the plain version, an int32
    product."""
    if x_q.device.type != "cuda":
        return torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    M, K = x_q.shape
    N = w_q.shape[1]
    Mp = max(M, INT8_MIN_ROWS)
    Kp, Np = _round_up(K, INT8_DIM_MULTIPLE), _round_up(N, INT8_DIM_MULTIPLE)
    if (Mp, Kp) != (M, K):
        x_q = torch.nn.functional.pad(x_q, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        w_q = torch.nn.functional.pad(w_q, (0, Np - N, 0, Kp - K))
    acc = torch._int_mm(x_q.contiguous(), w_q.contiguous())
    return acc[:M, :N] if (Mp, Np) != (M, N) else acc


def _int8_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The int8 serving path (models/quantize.py), as the JAX package's
    linear_apply computes it: a per-token scale a_s = max(max|x| / 127,
    1e-12) in fp32, x_q = clip(round(x / a_s), -127, 127) as int8 (round half
    to even in both frameworks), the int8 product accumulated in int32, then
    acc * (a_s * w_s) + b in fp32, returned in x's dtype. The divisions are
    by tensors on x's device: CUDA divides by a host scalar as a product with
    its reciprocal, which can differ in the last bit."""
    d_in = x.shape[-1]
    x2 = x.reshape(-1, d_in)
    a_s = torch.amax(torch.abs(x2), dim=-1, keepdim=True).to(torch.float32)
    a_s = torch.clamp(a_s / torch.full((), 127.0, device=x.device), min=1e-12)
    x_q = torch.clamp(torch.round(x2.to(torch.float32) / a_s), -127, 127).to(torch.int8)
    acc = int8_matmul(x_q, p["w_q"])
    y = acc.to(torch.float32) * (a_s * p["w_s"].to(torch.float32)) + p["b"].to(torch.float32)
    return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b, accumulated in fp32 with the bias added in fp32, returned in
    x's dtype. bf16 on CUDA: bf16 x bf16 products with fp32 accumulation
    (`_Bf16Linear`); elsewhere the plain version: both operands upcast to
    fp32 (a product of two bf16 values is exact in fp32), an fp32 product.
    Quantized params ({"w_q", "w_s", "b"}) take the int8 path (`_int8_linear`)."""
    if "w_q" in p:
        return _int8_linear(p, x)
    if _takes_bf16_gemm(x, p):
        y = _Bf16Linear.apply(x.reshape(-1, x.shape[-1]), p["w"], p["b"])
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = torch.matmul(x.float(), p["w"].float()) + p["b"].float()
    return y.to(x.dtype)


def masked_batch_norm(p: Params, x: torch.Tensor, mask: torch.Tensor,
                      per_query: bool = False) -> torch.Tensor:
    """Feature-wise batch norm over real documents only (biased variance).

    per_query=False: statistics across all real docs of the batch (BN);
    per_query=True: statistics per query over its own real docs (BN2).
    x: [B, N, F]; mask: [B, N] bool. Under data parallelism BN's sums span
    every rank's rows (parallel/collectives.py::global_sum); under context
    parallelism they span every rank's docs too, and BN2's a query's docs
    over the `seq` ranks (query_sum).
    """
    in_dtype = x.dtype
    x = x.float()
    m = mask[..., None].float()
    dims = (1,) if per_query else (0, 1)
    total = query_sum if per_query else global_sum
    # the count and the sum in one reduction
    count_sum = total(torch.cat([m.sum(dim=dims, keepdim=True),
                                 (x * m).sum(dim=dims, keepdim=True)], dim=-1))
    count = torch.clamp(count_sum[..., :1], min=1.0)
    mean = count_sum[..., 1:] / count
    var = total((torch.square(x - mean) * m).sum(dim=dims, keepdim=True)) / count
    y = (x - mean) * torch.rsqrt(var + _BN_EPS)
    if "gamma" in p:
        y = y * p["gamma"].float() + p["beta"].float()
    # padded rows stay zero so they cannot leak through later layers
    return (y * m).to(in_dtype)


def batch_norm_init(num_features: int, affine: bool, device="cpu") -> Params:
    if not affine:
        return {}
    return {"gamma": torch.ones(num_features, device=device),
            "beta": torch.zeros(num_features, device=device)}


def layer_norm_init(num_features: int, device="cpu") -> Params:
    return {"a": torch.ones(num_features, device=device),
            "b": torch.zeros(num_features, device=device)}


def layer_norm_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """a * (x - mean) / (std + eps) + b with the UNBIASED std, stats in fp32."""
    in_dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = torch.square(x - mean).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    # grad-safe sqrt: a constant row (the all-zero output of an all-padded
    # query at init) has var == 0, where d sqrt(v)/dv = inf would put NaN
    # into every parameter's gradient. The double where keeps the forward
    # identical and routes the backward through the safe branch.
    safe = var > 0
    std = torch.where(safe, torch.sqrt(torch.where(safe, var, 1.0)), 0.0)
    return (p["a"].float() * (x - mean) / (std + _LN_EPS) + p["b"].float()).to(in_dtype)


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            training: bool, split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and scale it
    by 1/(1 - rate). The keep-mask comes from `gen`, a generator on x's
    device (drawn for the global batch under data parallelism, and at the
    full width of a dim that `split` says is cut over `model`:
    collectives.batch_rand); without one, or out of training, x passes
    unchanged."""
    if not training or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    keep_mask = batch_rand(x.shape, gen, x.device, split=split) < keep
    return torch.where(keep_mask, x / keep, 0.0)


class _Bf16Partial(torch.autograd.Function):
    """fp32 x @ w for bf16 x, w on CUDA without the bias: a row-parallel
    layer's partial product, summed over `model` before the bias is added
    and the sum rounded once to bf16. The backward is `_Bf16Linear`'s: the
    incoming fp32 gradient is the bf16 output's, so its bf16 cast is exact."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dy = dy.to(x2.dtype)
        dx = _mm_f32(dy, w.t()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(x2.t(), dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def row_linear(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel layer under a ModelParallel share `tp`: x holds this
    rank's block of the input features and p["w"] the matching rows; the
    partial products (fp32) are summed over `model` (`tp.reduce`), then the
    whole bias is added in fp32 and the sum returned in x's dtype, as
    `linear_apply` rounds one device's product."""
    if "w_q" in p:
        raise NotImplementedError("int8 params are served on one device; a tensor-parallel "
                                  "share takes fp32 or bf16 params")
    if _takes_bf16_gemm(x, p):
        part = _Bf16Partial.apply(x.reshape(-1, x.shape[-1]), p["w"])
        part = part.reshape(*x.shape[:-1], part.shape[-1])
    else:
        part = torch.matmul(x.float(), p["w"].float())
    return (tp.reduce(part) + p["b"].float()).to(x.dtype)


def tp_linear(p: Params, x: torch.Tensor, x_split: bool, tp, spec) -> Tuple[torch.Tensor, bool]:
    """One linear layer under a ModelParallel share by its spec (the
    Split of p["w"]): whole (None), column (dim 1: the rank's output
    columns, x whole) or row (dim 0: the rank's input rows, x split).
    `x_split` says whether x holds this rank's block of its features;
    returns (y, whether y does)."""
    if spec is None or spec.dim == 1:
        if x_split:
            x = tp.gather(x)
        if spec is None:
            return linear_apply(p, x), False
        return linear_apply(p, tp.copy(x)), True
    if not x_split:
        x = tp.take(x)
    return row_linear(p, x, tp), False


def column_split(x: torch.Tensor, tp) -> Tuple[int, int, int]:
    """batch_rand's split of a column-split activation x."""
    start, _ = tp.block(x.shape[-1] * tp.degree)
    return x.dim() - 1, x.shape[-1] * tp.degree, start


def ffn_init(gen: torch.Generator, ff_dims: Sequence[int], BN: bool = True,
             bn_affine: bool = False, apply_tl_af: bool = False, device="cpu") -> Params:
    """Hidden layers are linear -> [BN] -> AF; the last layer is linear ->
    [BN -> TL_AF] when apply_tl_af."""
    if len(ff_dims) < 2:
        raise ValueError(f"ff_dims needs at least 2 entries, got {ff_dims}")
    n_linear = len(ff_dims) - 1
    layers: List[Params] = []
    for i in range(n_linear - 1):
        lp: Params = {"linear": linear_init(gen, ff_dims[i], ff_dims[i + 1], device)}
        if BN:
            lp["bn"] = batch_norm_init(ff_dims[i + 1], bn_affine, device)
        layers.append(lp)
    last: Params = {"linear": linear_init(gen, ff_dims[-2], ff_dims[-1], device)}
    if apply_tl_af and BN:
        last["bn"] = batch_norm_init(ff_dims[-1], bn_affine, device)
    layers.append(last)
    return {"layers": layers}


def ffn_apply(p: Params, x: torch.Tensor, mask: torch.Tensor, AF: str = "R",
              TL_AF: str = "S", apply_tl_af: bool = False, BN: bool = True,
              bn_per_query: bool = False, drop_rate: float = 0.1, training: bool = False,
              gen: Optional[torch.Generator] = None, tp=None) -> torch.Tensor:
    """x: [B, N, d_in] -> [B, N, d_out]. In training, dropout comes before
    each hidden layer's linear (not before the last one).

    `tp`, a ModelParallel share of the stack (parallel/tensor.py), runs each
    layer by its Split (`tp_linear`): after a column layer the activation
    is this rank's block of features; its batch norm normalises them with
    the rank's slice of gamma and beta (features are independent, so the
    statistics need no `model` sum), dropout draws the full width and keeps
    the block, and a softmax activation ("ST") first gathers the width. The
    last layer is whole, so the output is whole."""
    if tp is not None and not tp.splits_any():
        tp = None
    af = get_af(AF)
    layers = p["layers"]
    split = False  # x holds this rank's block of its features
    for i, lp in enumerate(layers):
        last = i == len(layers) - 1
        if not last:
            x = dropout(gen, x, drop_rate, training, column_split(x, tp) if split else None)
        if tp is None:
            x = linear_apply(lp["linear"], x)
        else:
            x, split = tp_linear(lp["linear"], x, split, tp, tp.spec["layers"][i]["linear"]["w"])
        if last and not apply_tl_af:
            break
        if BN:
            bn = lp["bn"]
            if split:
                bn = {k: tp.take(v) for k, v in bn.items()}
            x = masked_batch_norm(bn, x, mask, per_query=bn_per_query)
        act = get_af(TL_AF) if last else af
        if split and act is _ACTIVATIONS["ST"]:
            x, split = tp.gather(x), False
        x = act(x)
    return x
