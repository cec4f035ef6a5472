"""The fused pairwise lambda loss (RankNet / LambdaRank core): CUDA kernels and
their plain versions.

Counterpart of ptranking_tpu/ops/pallas/pairwise.py. Inputs are rows sorted
by predicted score with pads last (LambdaRank) or in any order (RankNet):
scores s, labels l, normalised gains nG (gain / IDCG, 0 at pads) and the
mask, all [B, N]. The loss is

    sum_b sum_{i<j, both real} w_ij * [softplus(sigma*(s_i - s_j)) - t_ij*sigma*(s_i - s_j)]

with t_ij = (1 + clip(l_i - l_j, -1, 1)) / 2 and w_ij = |nG_i - nG_j| *
|1/log2(i+2) - 1/log2(j+2)| (weighted, LambdaRank) or 1 (RankNet). Its
gradient in the scores is dL/ds_i = sum_{j != i, both real} w_ij * sigma *
(sigmoid(sigma*(s_i - s_j)) - t_ij): the pair (j, i) gives i the same term
as the pair (i, j), since the core is odd and w symmetric.

  * `pairwise_lambda_loss_plain` / `pairwise_lambda_grad_plain` — the plain
    torch versions (dense [B, N, N]); what the CPU runs, and what the kernels
    are held against on the card.
  * `PAIRWISE_LAMBDA_FWD` / `PAIRWISE_LAMBDA_BWD` — the kernels of
    `csrc/pairwise_lambda.cu`, each with its launch count.
  * `pairwise_lambda_loss` — the loss as a `torch.autograd.Function`,
    differentiable in the scores only; `lambda_rank_fused` and
    `ranknet_fused` build its inputs from (scores, labels, mask).
"""

from __future__ import annotations

import ctypes

import torch

from ptranking_tpu_torch import EPSILON
from ptranking_tpu_torch.ops import cuda_build
from ptranking_tpu_torch.ops.gains import gain
from ptranking_tpu_torch.ops.pairwise import pair_mask, pairwise_diffs
from ptranking_tpu_torch.ops.sorting import sort_labels_by_scores
from ptranking_tpu_torch.types import LabelType

TILE = 128  # rows and columns of a block's tile of pairs (TI in csrc/pairwise_lambda.cu)
_MAX_BLOCKS = 2 ** 31 - 1  # grid.x, which folds the rows B into the tile pairs


def tile_pairs(N: int) -> int:
    """Tile pairs ti <= tj of one row: the forward's partials a row."""
    t = -(-N // TILE)
    return t * (t + 1) // 2


def check_row_shape(B: int, N: int) -> None:
    """The [B, N] shapes the kernels take: any positive B and N whose grids
    (tile pairs x B, and B*N / 256 for the backward's reduction) stay within
    2^31 - 1 blocks; raises otherwise."""
    if min(B, N) < 1:
        raise ValueError(f"unsupported shape {(B, N)}")
    blocks = max(tile_pairs(N) * B, -(-B * N // 256))
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"shape {(B, N)} needs {blocks} blocks, past the grid's {_MAX_BLOCKS}")


def _pair_terms(s, l, g, mask, sigma, weighted):
    """(sigma * (s_i - s_j), t_ij, w_ij, both-real) over [B, N, N]."""
    diffs = sigma * pairwise_diffs(s)
    targets = 0.5 * (1.0 + torch.clamp(pairwise_diffs(l), -1.0, 1.0))
    if weighted:
        n = s.shape[-1]
        disc = 1.0 / torch.log2(torch.arange(n, dtype=s.dtype, device=s.device) + 2.0)
        w = torch.abs(pairwise_diffs(g)) * torch.abs(pairwise_diffs(disc))[None]
    else:
        w = 1.0
    return diffs, targets, w, pair_mask(mask)


def pairwise_lambda_loss_plain(s, l, g, mask, sigma: float = 1.0,
                               weighted: bool = True) -> torch.Tensor:
    """The loss's value: pair terms of padded docs are selected out (their
    scores may be -1e9 or anything else), never multiplied by a 0 mask."""
    diffs, targets, w, valid = _pair_terms(s, l, g, mask, sigma, weighted)
    softplus = torch.clamp(diffs, min=0.0) + torch.log1p(torch.exp(-torch.abs(diffs)))
    n = s.shape[-1]
    i = torch.arange(n, device=s.device)
    upper = i[:, None] < i[None, :]
    return torch.sum(torch.where(valid & upper, (softplus - targets * diffs) * w, 0.0))


def pairwise_lambda_grad_plain(s, l, g, mask, sigma: float = 1.0,
                               weighted: bool = True) -> torch.Tensor:
    """dL/ds [B, N]: the row sums of the analytic pair gradient over j != i."""
    diffs, targets, w, valid = _pair_terms(s, l, g, mask, sigma, weighted)
    core = sigma * (torch.sigmoid(diffs) - targets) * w
    n = s.shape[-1]
    i = torch.arange(n, device=s.device)
    offdiag = i[:, None] != i[None, :]
    return torch.sum(torch.where(valid & offdiag, core, 0.0), dim=-1)


def _check_rows(s, l, g, mask):
    if s.dim() != 2 or l.shape != s.shape or g.shape != s.shape:
        raise ValueError(f"scores, labels and gains must share one [B, N] shape; got "
                         f"{tuple(s.shape)}, {tuple(l.shape)}, {tuple(g.shape)}")
    B, N = s.shape
    if mask.shape != (B, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [B, N] = {(B, N)}; got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if any(t.dtype != torch.float32 for t in (s, l, g)):
        raise ValueError("scores, labels and gains must be float32")
    check_row_shape(B, N)
    tensors = (s, l, g, mask)
    if any(not t.is_cuda or t.device != s.device for t in tensors):
        raise ValueError("scores, labels, gains and mask must be CUDA tensors on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("scores, labels, gains and mask must be contiguous")
    return B, N


_P = ctypes.c_void_p
_ROW_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]  # B, N, sigma, weighted, stream
_LIB = cuda_build.KernelLib("pairwise_lambda", {"pairwise_lambda_fwd": [_P] * 5 + _ROW_ARGS,
                                                "pairwise_lambda_bwd": [_P] * 7 + _ROW_ARGS})


def _launch(entry, ptrs, B, N, sigma, weighted, device):
    with torch.cuda.device(device):
        _LIB.call(entry, *ptrs, B, N, float(sigma), int(bool(weighted)),
                  torch.cuda.current_stream(device).cuda_stream)


class PairwiseLambdaFwd:
    """ctypes wrapper of the forward kernel of `csrc/pairwise_lambda.cu`:
    per-(query, tile pair) partial sums of the loss, [B, tile_pairs(N)]
    fp32. `launches` grows by one at each launch and nowhere else."""

    name = "pairwise_lambda_fwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, s, l, g, mask, sigma: float = 1.0, weighted: bool = True):
        B, N = _check_rows(s, l, g, mask)
        partials = torch.empty((B, tile_pairs(N)), dtype=torch.float32, device=s.device)
        _launch(self.name, (s.data_ptr(), l.data_ptr(), g.data_ptr(), mask.data_ptr(),
                            partials.data_ptr()), B, N, sigma, weighted, s.device)
        self.launches += 1
        return partials


class PairwiseLambdaBwd:
    """ctypes wrapper of the backward of `csrc/pairwise_lambda.cu`: dL/ds
    [B, N] fp32, scaled by the upstream gradient `scale` (a one-element fp32
    tensor on the device, read by the kernel: no host sync). One call runs
    the pair kernel, which writes each tile pair's row and column partials
    into a scratch tensor of 2 * B * ceil(N / TILE) * N floats, and the
    kernel that sums them per document in a fixed order: `launches` grows by
    two a call, one for each kernel launched, and nowhere else."""

    name = "pairwise_lambda_bwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, s, l, g, mask, scale, sigma: float = 1.0, weighted: bool = True):
        B, N = _check_rows(s, l, g, mask)
        if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != s.device:
            raise ValueError("scale must be one float32 value on the scores' device")
        scale = scale.contiguous()
        grad = torch.empty_like(s)
        scratch = torch.empty(2 * B * -(-N // TILE) * N, dtype=torch.float32, device=s.device)
        _launch(self.name, (s.data_ptr(), l.data_ptr(), g.data_ptr(), mask.data_ptr(),
                            scale.data_ptr(), grad.data_ptr(), scratch.data_ptr()),
                B, N, sigma, weighted, s.device)
        self.launches += 2  # the pair kernel and the reduction
        return grad


PAIRWISE_LAMBDA_FWD = PairwiseLambdaFwd()
PAIRWISE_LAMBDA_BWD = PairwiseLambdaBwd()


class _PairwiseLambdaLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, l, g, mask, sigma, weighted):
        s, l, g = (t.float().contiguous() for t in (s, l, g))
        mask = mask.contiguous()
        ctx.save_for_backward(s, l, g, mask)
        ctx.sigma, ctx.weighted = sigma, weighted
        if s.is_cuda:
            return torch.sum(PAIRWISE_LAMBDA_FWD(s, l, g, mask, sigma, weighted))
        return pairwise_lambda_loss_plain(s, l, g, mask, sigma, weighted)

    @staticmethod
    def backward(ctx, grad_out):
        s, l, g, mask = ctx.saved_tensors
        if s.is_cuda:
            grad = PAIRWISE_LAMBDA_BWD(s, l, g, mask, grad_out.float(), ctx.sigma, ctx.weighted)
        else:
            grad = grad_out * pairwise_lambda_grad_plain(s, l, g, mask, ctx.sigma, ctx.weighted)
        return grad, None, None, None, None, None


def pairwise_lambda_loss(sorted_scores, labels, n_gains, mask, sigma: float = 1.0,
                         weighted: bool = True) -> torch.Tensor:
    """The fused pairwise (weighted) BCE over valid i<j pairs, summed.
    Differentiable in `sorted_scores` only. CUDA tensors go through the
    kernels (a failed build or launch raises); CPU tensors through the plain
    versions."""
    if sorted_scores.device.type not in ("cuda", "cpu"):
        raise ValueError(f"pairwise_lambda_loss runs on CUDA or the CPU, not "
                         f"{sorted_scores.device}")
    return _PairwiseLambdaLoss.apply(sorted_scores, labels, n_gains, mask, sigma, weighted)


def lambda_rank_fused(scores, labels, mask, sigma: float = 1.0,
                      label_type: LabelType = LabelType.MultiLabel, **_):
    """LambdaRank through the fused loss; the same value and gradient as
    losses/listwise.py::lambda_rank's dense path."""
    from ptranking_tpu_torch.losses.listwise import _full_dcg

    sorted_scores, pred_sorted_labels, sorted_mask = sort_labels_by_scores(scores, labels, mask)
    idcg = torch.clamp(_full_dcg(labels, mask, label_type), min=EPSILON)
    n_gains = gain(torch.where(sorted_mask, pred_sorted_labels, 0.0), label_type) / idcg[:, None]
    return pairwise_lambda_loss(sorted_scores, pred_sorted_labels, n_gains, sorted_mask,
                                sigma, True)


def ranknet_fused(scores, labels, mask, sigma: float = 1.0, **_):
    """RankNet through the fused loss (weights 1). RankNet sums over unordered
    pairs, so the raw order needs no sort."""
    return pairwise_lambda_loss(scores, labels, torch.zeros_like(scores), mask, sigma, False)
