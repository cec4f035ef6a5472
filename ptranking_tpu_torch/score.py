"""Batch scoring CLI — the serving entry point, on the card by default.

    python -m ptranking_tpu_torch.score -ckpt fold1.pt -in test.txt -out run.txt \
        -data MQ2008_Super [-runid myrun] [-device cuda]

Reads a LETOR/LibSVM file, restores the ranker from a self-describing
checkpoint (the port's `.pt` or the JAX package's `.pkl`; `-quantize int8`
serves its int8-quantized copy) or loads an artifact of
`python -m ptranking_tpu_torch.export`, scores every query in padded buckets
and writes a TREC run file (qid Q0 docid rank score runid). The same flags
as `python -m ptranking_tpu.score`, plus `-device`.
"""

from __future__ import annotations

import argparse

import numpy as np

from ptranking_tpu_torch.data.dataset import BucketedDataset
from ptranking_tpu_torch.data.letor import YAHOO_LTR, load_letor_file, parse_letor_lines
from ptranking_tpu_torch.data.meta import get_data_meta
from ptranking_tpu_torch.export import ExportedScorer, artifact_kind
from ptranking_tpu_torch.train.ranker import AdhocRanker


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ptranking_tpu_torch.score")
    p.add_argument("-ckpt", required=True,
                   help="self-describing checkpoint (.pt or .pkl) or an artifact of "
                        "ptranking_tpu_torch.export")
    p.add_argument("-in", dest="in_path", required=True, help="LETOR/LibSVM file")
    p.add_argument("-out", dest="out_path", required=True, help="TREC run file to write")
    p.add_argument("-data", dest="data_id", default="GLTR_LETOR")
    p.add_argument("-runid", default="ptranking_tpu")
    # ~100-doc batches: BN scorers normalise with batch statistics, so
    # serving mirrors the ~100-doc eval batches training validated
    p.add_argument("-batch_docs", type=int, default=100)
    p.add_argument("-quantize", default="none", choices=("none", "int8"),
                   help="int8: per-channel int8 weights and per-token activation scales, "
                        "int8 products on the card (checkpoints only)")
    p.add_argument("-device", default="cuda", help="torch device (cpu for tests)")
    return p


def load_ranker(ckpt: str, quantize: str = "none", device="cuda"):
    """Shared serving loader (score_file and ptranking_tpu_torch.serve): an
    artifact of ptranking_tpu_torch.export serves as it is (ExportedScorer),
    otherwise a self-describing checkpoint of either package, int8-quantized
    on request (models/quantize.py). The JAX package's StableHLO .ptx is
    refused: export the checkpoint with the port."""
    kind = artifact_kind(ckpt)
    if kind == "jax":
        raise ValueError(
            f"{ckpt} is the JAX package's exported .ptx (StableHLO), which the port "
            "cannot run: export the checkpoint with `python -m ptranking_tpu_torch.export`")
    if kind == "torch":
        if quantize != "none":
            raise ValueError(
                "-quantize applies when serving a checkpoint; an artifact is already "
                "lowered: pass -quantize to ptranking_tpu_torch.export instead to bake "
                "int8 weights in")
        return ExportedScorer(ckpt, device=device)
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown -quantize {quantize!r}")
    ranker = AdhocRanker.from_checkpoint(ckpt, device=device)
    return ranker.quantized() if quantize == "int8" else ranker


def score_file(ckpt: str, in_path: str, out_path: str, data_id: str = "GLTR_LETOR",
               runid: str = "ptranking_tpu", batch_docs: int = 100,
               quantize: str = "none", device="cuda") -> int:
    """Score every query of a LETOR file into a TREC run; returns the rows written."""
    ranker = load_ranker(ckpt, quantize, device)
    queries = load_letor_file(in_path, data_id=data_id, min_docs=1, min_rele=0,
                              presort=False)
    ds = BucketedDataset(queries, batch_docs=batch_docs)
    docids = _docids_by_qid(in_path, data_id)  # real docids when the file has comments
    rows = 0
    with open(out_path, "w") as f:
        for batch in ds.batches():
            scores = ranker.predict(batch).cpu().numpy()
            mask = np.asarray(batch.mask)
            for i, qrow in enumerate(np.asarray(batch.qids)):
                if qrow < 0 or not mask[i].any():
                    continue  # all-padded remainder row
                n = int(mask[i].sum())
                order = np.argsort(-scores[i, :n], kind="stable")
                qid = ds.qid_for(batch, i)
                ids = docids.get(qid)
                for rank, j in enumerate(order, start=1):
                    docid = ids[j] if ids is not None else f"{qid}-d{j}"
                    f.write(f"{qid} Q0 {docid} {rank} {scores[i, j]:.6f} {runid}\n")
                    rows += 1
    return rows


def _docids_by_qid(in_path: str, data_id: str):
    """Real docids from LETOR '#docid = X' comments, grouped per qid in file
    order; {} when the dataset has no comments."""
    try:
        has_comment = get_data_meta(data_id).has_comment
    except (NotImplementedError, ValueError):
        has_comment = False  # generic ids carry no meta without a JSON data section
    if not has_comment:
        return {}
    with open(in_path, encoding="iso-8859-1") as f:
        parsed = parse_letor_lines(f, has_comment=True, one_indexed=data_id not in YAHOO_LTR)
    out = {}
    for qid, docid in zip(parsed[2], parsed[3]):
        out.setdefault(qid, []).append(docid)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    n = score_file(args.ckpt, args.in_path, args.out_path, data_id=args.data_id,
                   runid=args.runid, batch_docs=args.batch_docs,
                   quantize=args.quantize, device=args.device)
    print(f"wrote {n} rows to {args.out_path}")


if __name__ == "__main__":
    main()
