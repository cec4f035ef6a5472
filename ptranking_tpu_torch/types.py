"""Core typed containers, as in ptranking_tpu/types.py.

Every batch carries an explicit boolean mask: lists are padded into
fixed-width buckets and padded documents are marked False.
"""

from __future__ import annotations

import enum
from typing import Any, NamedTuple, Optional


class LabelType(enum.Enum):
    """Gain convention of the graded labels."""

    MultiLabel = 1  # gain = 2^label - 1
    Permutation = 2  # gain = label


class RankingBatch(NamedTuple):
    """One batch of padded query lists, as numpy arrays or torch tensors.

    features: [B, N, F] float — per-document feature vectors (0 for padding)
    labels:   [B, N]    float — graded relevance (0 for padding)
    mask:     [B, N]    bool  — True for real documents
    qids:     optional [B] int — query ids (host-side bookkeeping only)
    """

    features: Any
    labels: Any
    mask: Any
    qids: Optional[Any] = None

    @property
    def num_queries(self) -> int:
        return self.features.shape[0]

    @property
    def list_size(self) -> int:
        return self.features.shape[1]

    @property
    def num_features(self) -> int:
        return self.features.shape[2]
