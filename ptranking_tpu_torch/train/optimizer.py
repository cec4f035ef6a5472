"""Optimizer configuration, as in ptranking_tpu/train/optimizer.py.

Only the config is ported so far: checkpoints carry it, and the serving path
reads checkpoints. The optimizers themselves come with the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    opt: str = "Adam"  # Adam | RMS | Adagrad
    lr: float = 1e-4
    weight_decay: float = 1e-3
    lr_step_size: int = 20  # epochs per decay step
    lr_gamma: float = 0.5
