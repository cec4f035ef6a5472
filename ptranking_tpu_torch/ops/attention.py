"""Masked attention for the listwise scorer's MHSA: flash kernel and its plain version.

Counterpart of ptranking_tpu/ops/attention.py, in the eval form (no
attention-probability dropout):

  * `blockwise_attention` — the online-softmax loop over key blocks, in plain
    torch. It is the plain version of the kernel: what `flash_attention` runs
    on the CPU, and what the kernel is held against on the card.
  * `flash_attention` — the same function through the hand-written CUDA kernel
    `csrc/flash_attn_fwd.cu` for CUDA tensors, and through
    `blockwise_attention(block_size=min(128, N))` for CPU tensors, which is
    exactly what the JAX package lowers off-TPU (models/scorers/listsf.py).

Layouts are the JAX package's: q, k, v `[B, H, N, d]`, mask `[B, N]` (True =
real document). Masked keys get logit -1e9; rows whose keys are all masked
(padded remainder rows) are finite garbage by contract — every consumer
applies the mask.
"""

from __future__ import annotations

import ctypes

import torch

from ptranking_tpu_torch.ops import cuda_build

_NEG = -1e9


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, block_size: int = 512) -> torch.Tensor:
    """Online-softmax attention over key blocks of `block_size`: fp32 logits
    and accumulators, the block's probabilities rounded to v's dtype before
    the p.v product (as the JAX package does), output in q's dtype."""
    B, H, N, d = q.shape
    block = min(block_size, N)
    rem = (-N) % block
    if rem:  # pad the KEY axis; padded keys are masked out
        k = torch.nn.functional.pad(k, (0, 0, 0, rem))
        v = torch.nn.functional.pad(v, (0, 0, 0, rem))
        mask = torch.nn.functional.pad(mask, (0, rem), value=False)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    qf = q.float()
    num = torch.zeros((B, H, N, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    mx = torch.full((B, H, N), float("-inf"), dtype=torch.float32, device=q.device)
    for s in range(0, k.shape[2], block):
        kb, vb, mb = k[:, :, s:s + block], v[:, :, s:s + block], mask[:, s:s + block]
        logits = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        logits = torch.where(mb[:, None, None, :], logits, _NEG)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        part_num = torch.matmul(p.to(v.dtype).float(), vb.float())
        new_mx = torch.maximum(mx, m)
        alpha = torch.exp(mx - new_mx)
        beta = torch.exp(m - new_mx)
        num = num * alpha[..., None] + part_num * beta[..., None]
        den = den * alpha + p.sum(dim=-1) * beta
        mx = new_mx
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype)


class FlashAttnFwd:
    """ctypes wrapper of `csrc/flash_attn_fwd.cu` with its launch count.

    `launches` grows by one at each kernel launch and nowhere else, so a run
    can show that its attention went through the kernel."""

    name = "flash_attn_fwd"
    DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _fn(self):
        if self._lib is None:
            lib = cuda_build.load(self.name)
            lib.flash_attn_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.flash_attn_fwd.restype = ctypes.c_int
            lib.flash_attn_fwd_error_string.argtypes = [ctypes.c_int]
            lib.flash_attn_fwd_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"q, k, v must share one [B, H, N, d] shape; got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        B, H, N, d = q.shape
        if mask.shape != (B, N) or mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool [B, N] = {(B, N)}; got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if q.dtype not in self.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"q, k, v must all be float32 or bfloat16; got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if not 1 <= d <= 128:
            raise ValueError(f"head dim d={d} outside the kernel's 1..128")
        if B * H > 65535 or min(B, H, N) < 1:
            raise ValueError(f"unsupported shape {tuple(q.shape)}")
        tensors = (q, k, v, mask)
        if any(not t.is_cuda or t.device != q.device for t in tensors):
            raise ValueError("q, k, v and mask must be CUDA tensors on one device")
        if any(not t.is_contiguous() for t in tensors):
            raise ValueError("q, k, v and mask must be contiguous")
        lib = self._fn()
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     mask.data_ptr(), out.data_ptr(), B, H, N, d,
                                     self.DTYPES[q.dtype], stream)
        if err != 0:
            raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err} "
                               f"({lib.flash_attn_fwd_error_string(err).decode()})")
        self.launches += 1
        return out


FLASH_ATTN_FWD = FlashAttnFwd()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked non-causal attention, `sm_scale = 1/sqrt(d)`, no dropout.

    CUDA tensors go through the hand-written kernel (a failed build or launch
    raises; there is no fallback). CPU tensors go through
    `blockwise_attention(block_size=min(128, N))`."""
    if q.is_cuda:
        return FLASH_ATTN_FWD(q.contiguous(), k.contiguous(), v.contiguous(),
                              mask.contiguous())
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    return blockwise_attention(q, k, v, mask, block_size=min(128, max(q.shape[2], 1)))
