"""ptranking_tpu_torch — the PyTorch / CUDA port of ptranking_tpu.

The JAX package `ptranking_tpu` is the reference; this package mirrors its
module paths so each piece has an obvious counterpart, and runs on an NVIDIA
H100 with hand-written CUDA kernels where the JAX package has Pallas kernels.
It imports torch, numpy and the standard library only — never jax, optax or
anything under `ptranking_tpu`.

Entry points run on `device="cuda"` unless the caller asks for the CPU
(`device="cpu"`, as the tests do); asking for CUDA where there is none raises.
"""

import torch

__version__ = "0.1.0"

# Global constants, as in ptranking_tpu/__init__.py.
LTR_SEED = 137
EPSILON = 1e-8
# Large-negative sentinel that pushes padded documents to the tail of any
# descending sort. Finite (not -inf) so arithmetic on sorted scores stays NaN-free.
PAD_SCORE = -1e9


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Never falls back: CUDA asked
    for on a machine without it is an error, not a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
