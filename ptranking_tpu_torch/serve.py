"""HTTP scoring server over a self-describing checkpoint or an exported
artifact, stdlib only.

    python -m ptranking_tpu_torch.serve -ckpt model.pt -port 8080 [-quantize int8] [-device cuda]
    python -m ptranking_tpu_torch.serve -ckpt model.pttx -port 8080

The wire contract of `python -m ptranking_tpu.serve`:
  GET  /healthz            -> {"ok": true, "model_id": ..., "num_features": N}
  POST /score              body:
      {"queries": [{"qid": "q1", "docs": [[f0 .. fF-1], ...],
                    "docids": ["d0", ...]          # optional
                   }, ...]}
    -> {"results": [{"qid": "q1", "docids": [...ranked...],
                     "scores": [...sorted desc...]}, ...]}
A body of the wrong shape gets 400 with a message; a non-finite score is
sent as JSON null. Requests are batched into the same padded buckets as
training; the server is synchronous (ThreadingHTTPServer accepts concurrent
connections, scoring is serialised by a lock).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ptranking_tpu_torch.data.dataset import BucketedDataset
from ptranking_tpu_torch.score import load_ranker


class ScoringService:
    """Checkpoint or artifact -> callable scoring core (shared by HTTP and
    tests; no sockets involved)."""

    def __init__(self, ckpt: str, quantize: str = "none",
                 batch_docs: Optional[int] = None, device="cuda"):
        self.ranker = load_ranker(ckpt, quantize, device)
        self.num_features = int(getattr(self.ranker, "num_features", 0)
                                or self.ranker.scorer_cfg.num_features)
        self.model_id = self.ranker.model_id
        # an artifact has entries for the batch_docs it was exported with and
        # for its bucket widths alone: default to, and hold to, those
        artifact_bd = getattr(self.ranker, "batch_docs", None)
        if batch_docs is None:
            self.batch_docs = int(artifact_bd or 100)
        else:
            if artifact_bd is not None and int(batch_docs) != int(artifact_bd):
                raise ValueError(f"artifact was exported with batch_docs={artifact_bd}; "
                                 f"serve with that value (got {batch_docs})")
            self.batch_docs = int(batch_docs)
        self.buckets = getattr(self.ranker, "buckets", None)
        self._lock = threading.Lock()

    def info(self) -> dict:
        return {"ok": True, "model_id": self.model_id, "num_features": self.num_features}

    def score(self, payload: dict) -> dict:
        queries = payload.get("queries") if isinstance(payload, dict) else None
        if not isinstance(queries, list) or not queries:
            raise ValueError("body must be {'queries': [...]} (non-empty)")
        parsed = []
        for i, q in enumerate(queries):
            if not isinstance(q, dict):
                raise ValueError(f"queries[{i}] must be an object")
            try:
                docs = np.asarray(q.get("docs"), np.float32)
            except (TypeError, ValueError):
                docs = np.zeros(0, np.float32)
            if docs.ndim != 2 or docs.shape[0] == 0 or docs.shape[1] != self.num_features:
                raise ValueError(f"queries[{i}].docs must be [n_docs, {self.num_features}]")
            qid = str(q.get("qid", f"q{i}"))
            docids = q.get("docids") or [f"{qid}-d{j}" for j in range(len(docs))]
            if len(docids) != len(docs):
                raise ValueError(f"queries[{i}]: docids/docs length mismatch")
            parsed.append((qid, docs, docids))

        # one bucketed pass over the whole request; qids are positional
        # indices into `parsed`
        ds = BucketedDataset([(str(k), f, np.zeros(len(f), np.float32))
                              for k, (_, f, _) in enumerate(parsed)],
                             batch_docs=self.batch_docs, num_features=self.num_features,
                             buckets=self.buckets)
        results = [None] * len(parsed)
        with self._lock:
            for batch in ds.batches():
                scores = self.ranker.predict(batch).cpu().numpy()
                mask = np.asarray(batch.mask)
                for row in range(scores.shape[0]):
                    if not mask[row].any():
                        continue  # all-padded remainder row
                    k = int(ds.qid_for(batch, row))
                    qid, _, docids = parsed[k]
                    n = int(mask[row].sum())
                    order = np.argsort(-scores[row, :n], kind="stable")
                    vals = [float(scores[row, j]) for j in order]
                    results[k] = {
                        "qid": qid,
                        "docids": [docids[j] for j in order],
                        # strict JSON has no NaN/Infinity tokens
                        "scores": [v if np.isfinite(v) else None for v in vals],
                    }
        return {"results": results}


def make_server(service: ScoringService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.info())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/score":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError) as exc:  # bad JSON or header
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                self._send(200, service.score(payload))
            except ValueError as exc:  # bad request shape/width
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # server-side fault: report it, keep serving
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser("python -m ptranking_tpu_torch.serve")
    p.add_argument("-ckpt", required=True,
                   help="self-describing checkpoint (.pt or .pkl) or an artifact of "
                        "ptranking_tpu_torch.export")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-batch_docs", type=int, default=None,
                   help="docs per padded batch (default: an artifact's own, else 100)")
    p.add_argument("-quantize", default="none", choices=("none", "int8"))
    p.add_argument("-device", default="cuda", help="torch device (cpu for tests)")
    args = p.parse_args(argv)
    service = ScoringService(args.ckpt, quantize=args.quantize,
                             batch_docs=args.batch_docs, device=args.device)
    server = make_server(service, args.host, args.port)
    print(f"serving {service.model_id} (F={service.num_features}) "
          f"on http://{args.host}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
