"""Optimizers and the StepLR schedule, as in ptranking_tpu/train/optimizer.py.

The JAX package chains optax transforms: coupled L2 weight decay (wd*p added
to the gradient before the moments, torch-style), then Adam, RMSprop or
Adagrad, then the learning rate, which StepLR(step_size, gamma) sets once per
epoch. The port computes the same rules:

  * Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=wd)`: optax's scale_by_adam with eps outside the root and
    bias correction is torch's update.
  * Adagrad and RMSprop are this module's own. optax puts eps INSIDE the
    root (`g * rsqrt(sum + 1e-10)`, `g * rsqrt(nu + 1e-8)`) where
    torch.optim adds it outside (`g / (sqrt(sum) + eps)`); at a first-step
    gradient of 1e-5 the two Adagrad steps differ by 30%.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    opt: str = "Adam"  # Adam | RMS | Adagrad
    lr: float = 1e-4
    weight_decay: float = 1e-3
    lr_step_size: int = 20  # epochs per decay step
    lr_gamma: float = 0.5


class Adagrad(torch.optim.Optimizer):
    """optax's scale_by_rss after coupled weight decay: g += wd*p;
    sum += g^2; p -= lr * g * rsqrt(sum + eps) where sum > 0, else 0.
    State per parameter: "sum"."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + group["weight_decay"] * p if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["sum"] = torch.zeros_like(p)
                total = state["sum"]
                total.addcmul_(g, g)
                inv = torch.where(total > 0, torch.rsqrt(total + group["eps"]), 0.0)
                p.sub_(group["lr"] * (inv * g))


class RMSprop(torch.optim.Optimizer):
    """optax's scale_by_rms (eps inside the root, no bias correction) after
    coupled weight decay: g += wd*p; nu = decay*nu + (1-decay)*g^2;
    p -= lr * g * rsqrt(nu + eps). State per parameter: "nu"."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + group["weight_decay"] * p if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - group["decay"]) * torch.square(g) + group["decay"] * nu)
                p.sub_(group["lr"] * (torch.rsqrt(nu + group["eps"]) * g))


def make_optimizer(cfg: OptimizerConfig, params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer of `cfg` over a list of parameter tensors, at lr = cfg.lr."""
    if cfg.opt == "Adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    if cfg.opt == "RMS":
        return RMSprop(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    if cfg.opt == "Adagrad":
        return Adagrad(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    raise NotImplementedError(cfg.opt)


def epoch_lr(cfg: OptimizerConfig, epoch_k: int) -> float:
    """StepLR(step_size, gamma) at the 1-based epoch counter: epoch e trains at
    lr * gamma^((e-1)//step_size)."""
    return cfg.lr * (cfg.lr_gamma ** ((epoch_k - 1) // cfg.lr_step_size))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write the learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
