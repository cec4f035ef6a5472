"""The log-domain Sinkhorn half-step as a CUDA kernel.

Counterpart of ptranking_tpu/ops/pallas/sinkhorn.py. One call computes

    out[b, j] = log_marginal[b, j] - LSE_i(-cost[b, i, j] / lam + log_u[b, i])

or, with `transposed=True`, the same half-step on the transposed cost matrix
without a transposed copy:

    out[b, i] = log_marginal[b, i] - LSE_j(-cost[b, i, j] / lam + log_u[b, j])

with the LSE's guards of ops/sinkhorn.py::_lse (entries at -1e30 add exactly
0; an all-padded reduction gives finite garbage). `SINKSTEP` is the kernel of
`csrc/sinkstep.cu` with its launch count; its plain version is
ops/sinkhorn.py::log_sinkstep, which the CPU runs and the kernel is held
against on the card. The half-step has no gradient: `sinkhorn_distance`'s
backward is analytic, so the output carries no graph.
"""

from __future__ import annotations

import ctypes

import torch

from ptranking_tpu_torch.ops import cuda_build

_P = ctypes.c_void_p
_LIB = cuda_build.KernelLib("sinkstep", {
    # cost, log_marginal, log_u, out, B, N, lam, transposed, stream
    "sinkstep": [_P] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]})


class Sinkstep:
    """ctypes wrapper of the kernel of `csrc/sinkstep.cu`: [B, N] fp32 out of
    cost [B, N, N] and log_marginal, log_u [B, N], all fp32, contiguous and on
    one CUDA device. `launches` grows by one at each launch and nowhere else."""

    name = "sinkstep"

    def __init__(self):
        self.launches = 0

    def __call__(self, cost: torch.Tensor, log_marginal: torch.Tensor, log_u: torch.Tensor,
                 lam: float, transposed: bool = False) -> torch.Tensor:
        if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
            raise ValueError(f"cost must be [B, N, N]; got {tuple(cost.shape)}")
        B, N = cost.shape[0], cost.shape[1]
        if log_marginal.shape != (B, N) or log_u.shape != (B, N):
            raise ValueError(f"log_marginal and log_u must be [B, N] = {(B, N)}; got "
                             f"{tuple(log_marginal.shape)}, {tuple(log_u.shape)}")
        tensors = (cost, log_marginal, log_u)
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("cost, log_marginal and log_u must be float32")
        if any(not t.is_cuda or t.device != cost.device for t in tensors):
            raise ValueError("cost, log_marginal and log_u must be CUDA tensors on one device")
        if any(not t.is_contiguous() for t in tensors):
            raise ValueError("cost, log_marginal and log_u must be contiguous")
        if B < 1 or N < 1 or not lam > 0:
            raise ValueError(f"unsupported shape {(B, N)} or lam {lam}")
        out = torch.empty_like(log_marginal)
        with torch.cuda.device(cost.device):
            _LIB.call(self.name, cost.data_ptr(), log_marginal.data_ptr(), log_u.data_ptr(),
                      out.data_ptr(), B, N, float(lam), int(bool(transposed)),
                      torch.cuda.current_stream(cost.device).cuda_stream)
        self.launches += 1
        return out


SINKSTEP = Sinkstep()
