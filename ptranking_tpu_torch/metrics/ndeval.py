"""Python driver for the native ndeval oracle (native/ndeval.cpp).

The port's copy of ptranking_tpu/metrics/ndeval.py. TREC's ndeval reads a
diversity qrels file and a run file and prints its measures as CSV, one row
a topic and an `amean` row. The port builds the unchanged C++ source with
its own native builder (utils/native_build.py) into `build/native/ndeval`,
never into the JAX package's `native/build/`, and parses the CSV, so the
on-device SRD metrics (metrics/srd.py) can be held against the official
off-device tool.
"""

from __future__ import annotations

import csv
import io
import os
import subprocess
from typing import Dict, List, Optional, Sequence

from ptranking_tpu_torch.utils.native_build import (NATIVE_BUILD_DIR, NATIVE_SRC_DIR,
                                                    build_native)


def ndeval_binary() -> Optional[str]:
    """Path to the compiled ndeval binary, built on first use; None without
    a C++ compiler. A compile error raises."""
    return build_native(os.path.join(NATIVE_SRC_DIR, "ndeval.cpp"),
                        os.path.join(NATIVE_BUILD_DIR, "ndeval"))


def run_ndeval(qrels_path: str, run_path: str, alpha: float = 0.5,
               beta: float = 0.5, traditional: bool = False,
               complete: bool = False, depth: int = 0,
               ) -> Dict[str, Dict[str, float]]:
    """Run ndeval and return {topic (str, 'amean' included): {measure: value}}."""
    binary = ndeval_binary()
    if binary is None:
        raise RuntimeError("no C++ toolchain available to build ndeval")
    cmd: List[str] = [binary, "-alpha", str(alpha), "-beta", str(beta)]
    if traditional:
        cmd.append("-traditional")
    if complete:
        cmd.append("-c")
    if depth:
        cmd += ["-M", str(depth)]
    cmd += [qrels_path, run_path]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    out: Dict[str, Dict[str, float]] = {}
    for row in csv.DictReader(io.StringIO(proc.stdout)):
        topic = row.pop("topic")
        row.pop("runid", None)
        out[topic] = {k: float(v) for k, v in row.items()}
    return out


def write_qrels(path: str, rows: Sequence[tuple]):
    """rows: (topic, subtopic, docno, judgment)."""
    with open(path, "w") as f:
        for topic, sub, docno, judgment in rows:
            f.write(f"{topic} {sub} {docno} {judgment}\n")


def write_run(path: str, rows: Sequence[tuple], runid: str = "ptranking_tpu"):
    """rows: (topic, docno, rank, score)."""
    with open(path, "w") as f:
        for topic, docno, rank, score in rows:
            f.write(f"{topic} Q0 {docno} {rank} {score:.6f} {runid}\n")
