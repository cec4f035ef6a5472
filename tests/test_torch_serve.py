"""The port's serving path (score.py, serve.py, train/ranker.py) against the
JAX package's, on a checkpoint the JAX package saved."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ptranking_tpu.data.dataset import make_synthetic_queries
from ptranking_tpu.data.letor import write_letor_file
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu_torch.score import load_ranker, main as score_main, score_file
from ptranking_tpu_torch.serve import ScoringService, make_server

torch.set_num_threads(1)

F = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-saved .pkl of a tiny flash listsf ranker and a LETOR file with
    '#docid' comments (data_id MQ2008_Super)."""
    d = tmp_path_factory.mktemp("torch_serve")
    cfg = JaxScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 32), flash_attn=True)
    ranker = JaxRanker("LambdaRank", cfg).init()
    pkl = str(d / "ranker.pkl")
    ranker.save(pkl)
    queries = make_synthetic_queries(9, num_features=F, min_docs=3, max_docs=60, seed=4)
    letor = write_letor_file(queries, str(d / "test.txt"))
    return pkl, letor, d


def _run_lines(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    return [(r[0], r[2], int(r[3])) for r in rows], np.array([float(r[4]) for r in rows])


def test_score_file_matches_jax(files):
    from ptranking_tpu.score import score_file as jax_score_file

    pkl, letor, d = files
    nj = jax_score_file(pkl, letor, str(d / "jax.run"), data_id="MQ2008_Super")
    nt = score_file(pkl, letor, str(d / "torch.run"), data_id="MQ2008_Super", device="cpu")
    assert nj == nt > 0
    jrank, jscore = _run_lines(d / "jax.run")
    trank, tscore = _run_lines(d / "torch.run")
    assert trank == jrank  # same qids, docids and ranks, line for line
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=1e-5)


def test_pt_checkpoint_round_trip_and_cli(files):
    pkl, letor, d = files
    ranker = load_ranker(pkl, device="cpu")
    pt = str(d / "ranker.pt")
    ranker.save(pt)
    again = load_ranker(pt, device="cpu")
    assert again.scorer_cfg == ranker.scorer_cfg and again.model_id == "LambdaRank"
    score_main(["-ckpt", pt, "-in", letor, "-out", str(d / "pt.run"),
                "-data", "MQ2008_Super", "-device", "cpu"])
    score_file(pkl, letor, str(d / "pkl.run"), data_id="MQ2008_Super", device="cpu")
    assert (d / "pt.run").read_text() == (d / "pkl.run").read_text()


def test_later_slices_raise_not_implemented(files):
    """What raised before the serving slice's rest was ported: -quantize int8
    now serves an inference-only int8 copy, and the JAX package's .ptx is
    refused with a pointer to the port's own export."""
    pkl, _, d = files
    q = load_ranker(pkl, quantize="int8", device="cpu")
    assert "w_q" in q.params["tail_ffnns"]["layers"][0]["linear"] and q._optimizer is None
    art = d / "scorer.ptx"
    art.write_bytes(b"PTRX" + b"\0" * 16)
    with pytest.raises(ValueError, match="ptranking_tpu_torch.export"):
        load_ranker(str(art), device="cpu")


def test_scoring_service_matches_jax(files):
    from ptranking_tpu.serve import ScoringService as JaxService

    pkl, _, _ = files
    rng = np.random.RandomState(0)
    payload = {"queries": [
        {"qid": "qa", "docs": rng.randn(7, F).tolist(), "docids": [f"a{j}" for j in range(7)]},
        {"qid": "qb", "docs": rng.randn(45, F).tolist()},
        {"qid": "qc", "docs": rng.randn(130, F).tolist()},
    ]}
    want = JaxService(pkl).score(payload)["results"]
    got = ScoringService(pkl, device="cpu").score(payload)["results"]
    for w, g in zip(want, got):
        assert g["qid"] == w["qid"] and g["docids"] == w["docids"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(files):
    pkl, _, _ = files
    service = ScoringService(pkl, device="cpu")
    server = make_server(service, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            info = json.loads(resp.read())
        assert info == {"ok": True, "model_id": "LambdaRank", "num_features": F}

        rng = np.random.RandomState(1)
        docs = rng.randn(6, F).astype(np.float32)
        status, out = _post(f"{base}/score", {"queries": [
            {"qid": "qa", "docs": docs.tolist()}]})
        assert status == 200
        direct = service.score({"queries": [{"qid": "qa", "docs": docs.tolist()}]})
        assert out == json.loads(json.dumps(direct))
        assert out["results"][0]["scores"] == sorted(out["results"][0]["scores"], reverse=True)

        # wrong feature width and a wrong body -> 400 with a message
        status, err = _post(f"{base}/score", {"queries": [{"qid": "bad", "docs": [[1.0, 2.0]]}]})
        assert status == 400 and "docs must be" in err["error"]
        status, err = _post(f"{base}/score", {"nope": 1})
        assert status == 400

        # non-finite scores become JSON null, never NaN/Infinity tokens
        status, out = _post(f"{base}/score", {"queries": [
            {"qid": "big", "docs": np.full((2, F), 1e38).tolist()}]})
        assert status == 200
        for v in out["results"][0]["scores"]:
            assert v is None or np.isfinite(v)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_loading_a_jax_checkpoint_imports_no_jax(files):
    """A fresh process loads the JAX-saved .pkl and scores with the port;
    no jax, optax or ptranking_tpu module gets imported on the way."""
    pkl, _, _ = files
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import numpy as np\n"
        "from ptranking_tpu_torch.serve import ScoringService\n"
        f"s = ScoringService({pkl!r}, device='cpu')\n"
        f"out = s.score({{'queries': [{{'docs': np.ones((5, {F})).tolist()}}]}})\n"
        "assert len(out['results'][0]['scores']) == 5\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'ptranking_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
