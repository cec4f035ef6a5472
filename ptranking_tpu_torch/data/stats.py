"""Dataset statistics as a CLI: doc counts, docs per query, the label
distribution and the feature range, to check a parse against a dataset's
published statistics.

Counterpart of ptranking_tpu/data/stats.py (the same statistics and output).

    python -m ptranking_tpu_torch.data.stats -data MSLRWEB30K -file Fold1/train.txt
    python -m ptranking_tpu_torch.data.stats -data SyntheticMQ            # synthetic
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict, Sequence

import numpy as np


def dataset_statistics(queries: Sequence) -> Dict:
    """Statistics of parsed (qid, features [N, F], labels [N]) query tuples."""
    if not queries:
        return {"num_queries": 0}
    sizes = np.asarray([len(q[2]) for q in queries])
    all_labels = np.concatenate([np.asarray(q[2]) for q in queries])
    feats = np.concatenate([np.asarray(q[1]) for q in queries], axis=0)
    label_counts = Counter(all_labels.astype(int).tolist())
    return {
        "num_queries": len(queries),
        "num_docs": int(sizes.sum()),
        "min_docs_per_query": int(sizes.min()),
        "max_docs_per_query": int(sizes.max()),
        "mean_docs_per_query": float(sizes.mean()),
        "num_features": int(feats.shape[1]),
        "feature_min": float(feats.min()),
        "feature_max": float(feats.max()),
        "label_distribution": {int(k): int(v) for k, v in sorted(label_counts.items())},
        "pct_queries_with_relevant": float(
            np.mean([bool((np.asarray(q[2]) > 0).any()) for q in queries])),
    }


def print_statistics(stats: Dict, title: str = "dataset"):
    print(f"== {title} ==")
    for k, v in stats.items():
        if k == "label_distribution":
            dist = ", ".join(f"{g}: {c}" for g, c in v.items())
            print(f"  label_distribution: {dist}")
        else:
            print(f"  {k}: {v}")


def main(argv=None):
    p = argparse.ArgumentParser("ptranking_tpu_torch.data.stats")
    p.add_argument("-data", dest="data_id", default="GLTR_LETOR")
    p.add_argument("-file", dest="path", default=None, help="LETOR/LibSVM file")
    p.add_argument("-min_docs", type=int, default=1)
    p.add_argument("-min_rele", type=int, default=0)
    args = p.parse_args(argv)

    if args.path is None:
        from ptranking_tpu_torch.data.dataset import make_synthetic_queries
        from ptranking_tpu_torch.data.meta import get_data_meta

        try:
            num_features = get_data_meta(args.data_id).num_features
        except (NotImplementedError, ValueError):
            num_features = 46  # generic ids carry no meta; an MQ-like default
        queries = make_synthetic_queries(num_queries=200, num_features=num_features, seed=7)
        title = f"{args.data_id} (synthetic)"
    else:
        from ptranking_tpu_torch.data.letor import load_letor_file

        queries = load_letor_file(args.path, data_id=args.data_id, min_docs=args.min_docs,
                                  min_rele=args.min_rele, presort=False)
        title = f"{args.data_id}: {args.path}"
    stats = dataset_statistics(queries)
    print_statistics(stats, title)
    return stats


if __name__ == "__main__":
    main()
