"""The port's exported scoring artifacts (export.py): a CPU artifact scores as
its checkpoint does, plain and int8; its buckets and batch sizes are the JAX
package's export's; the serving loaders take it and refuse what the JAX
package refuses; the registered attention op traces."""

import collections
import pickle

import numpy as np
import pytest
import torch

from ptranking_tpu.data.dataset import make_synthetic_queries
from ptranking_tpu.data.letor import write_letor_file
from ptranking_tpu.export import export_scorer as jax_export
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu_torch import export
from ptranking_tpu_torch.data.dataset import BucketedDataset
from ptranking_tpu_torch.score import load_ranker, score_file
from ptranking_tpu_torch.serve import ScoringService

torch.set_num_threads(1)

F = 12


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-saved .pkl of a tiny flash listsf ranker in bf16, its .pt, and a
    LETOR file with lists of 3..60 docs."""
    d = tmp_path_factory.mktemp("torch_export")
    cfg = JaxScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 32), flash_attn=True,
                                         compute_dtype="bfloat16")
    pkl = str(d / "ranker.pkl")
    JaxRanker("LambdaRank", cfg).init().save(pkl)
    pt = str(d / "ranker.pt")
    load_ranker(pkl, device="cpu").save(pt)
    qs = make_synthetic_queries(9, num_features=F, min_docs=3, max_docs=60, seed=4)
    letor = write_letor_file(qs, str(d / "test.txt"))
    return pkl, pt, letor, d


@pytest.fixture(scope="module")
def artifacts(ckpt):
    """CPU artifacts of the .pt checkpoint, plain and int8, at buckets 16..64."""
    _, pt, _, d = ckpt
    out = {}
    for q in ("none", "int8"):
        path = str(d / f"ranker_{q}.pttx")
        blob = export.export_scorer(pt, path, batch_docs=100, buckets=(16, 32, 64),
                                    platforms=["cpu"], quantize=q, device="cpu")
        out[q] = (path, blob)
    return out


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_cpu_artifact_scores_as_its_checkpoint(ckpt, artifacts, quantize):
    """Every entry of the artifact gives the checkpoint's (quantized)
    ranker's scores bit for bit on the real docs, and the artifact holds one
    cpu program a bucket."""
    _, pt, _, _ = ckpt
    path, blob = artifacts[quantize]
    assert blob["platforms"] == ["cpu"] and blob["quantize"] == quantize
    assert sorted(blob["entries"]) == [(2, 64), (3, 32), (6, 16)]
    served = export.ExportedScorer(path, device="cpu")
    ranker = load_ranker(pt, quantize=quantize, device="cpu")
    qs = make_synthetic_queries(20, num_features=F, min_docs=2, max_docs=64, seed=8)
    ds = BucketedDataset(qs, batch_docs=100, buckets=served.buckets)
    n = 0
    for batch in ds.batches():
        m = np.asarray(batch.mask)
        got = served.predict(batch).numpy()
        want = ranker.predict(batch).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got[m], want[m])
        n += 1
    assert n >= 3


@pytest.mark.parametrize("batch_docs,buckets,max_docs", [
    (100, (16, 32), None), (64, (16, 48), 150), (500, (256,), 1000)])
def test_bucket_shapes_match_jax_export(ckpt, batch_docs, buckets, max_docs):
    """The (B, N) entries: the JAX package's export of the same checkpoint
    has the same shapes (its bucket list, B = max(1, round(batch_docs / N))
    and doubling past the largest bucket until max_docs fits)."""
    pkl, _, _, d = ckpt
    blob = jax_export(pkl, str(d / "jax.ptx"), batch_docs=batch_docs, buckets=buckets,
                      platforms=["cpu"], max_docs=max_docs)
    assert sorted(export.bucket_shapes(batch_docs, buckets, max_docs)) == sorted(blob["entries"])


def test_default_bucket_shapes_match_jax():
    """The default buckets are the dataset's (16 .. 1536), as in JAX."""
    shapes = export.bucket_shapes(100)
    assert [n for _, n in shapes] == [16, 32, 64, 128, 256, 512, 1024, 1536]
    assert [b for b, _ in shapes] == [6, 3, 2, 1, 1, 1, 1, 1]
    assert [n for _, n in export.bucket_shapes(100, max_docs=5000)][-2:] == [3072, 6144]


def test_score_file_and_service_serve_the_artifact(ckpt, artifacts):
    """score_file writes the same run from the artifact as from the
    checkpoint; the HTTP service's core takes the artifact's batch_docs and
    buckets and answers as the checkpoint does."""
    _, pt, letor, d = ckpt
    path, _ = artifacts["none"]  # buckets 16..64 hold the file's lists of 3..60 docs
    score_file(path, letor, str(d / "art.run"), data_id="MQ2008_Super", device="cpu")
    score_file(pt, letor, str(d / "ckpt.run"), data_id="MQ2008_Super", device="cpu")
    assert (d / "art.run").read_text() == (d / "ckpt.run").read_text()

    svc = ScoringService(path, device="cpu")
    assert svc.batch_docs == 100 and tuple(svc.buckets) == (16, 32, 64)
    assert svc.info() == {"ok": True, "model_id": "LambdaRank", "num_features": F}
    rng = np.random.RandomState(0)
    payload = {"queries": [{"qid": "a", "docs": rng.randn(7, F).tolist()},
                           {"qid": "b", "docs": rng.randn(40, F).tolist()}]}
    want = ScoringService(pt, batch_docs=100, device="cpu").score(payload)
    assert svc.score(payload) == want
    with pytest.raises(ValueError, match="batch_docs=100"):
        ScoringService(path, batch_docs=50, device="cpu")


def test_export_cli(tmp_path):
    """`python -m ptranking_tpu_torch.export`: the default buckets, doubled
    past 1536 with -max_docs, for a pointsf checkpoint."""
    from ptranking_tpu_torch.models.scorers import ScorerConfig
    from ptranking_tpu_torch.train.ranker import AdhocRanker

    pt = str(tmp_path / "p.pt")
    AdhocRanker("RankMSE", ScorerConfig.default_pointsf(F, h_dim=8, num_layers=2),
                device="cpu").init().save(pt)
    out = str(tmp_path / "p.pttx")
    blob = export.main(["-ckpt", pt, "-out", out, "-max_docs", "2000", "-device", "cpu",
                        "-quantize", "int8"])
    assert [n for _, n in sorted(blob["entries"], key=lambda s: s[1])] == [
        16, 32, 64, 128, 256, 512, 1024, 1536, 3072]
    assert blob["platforms"] == ["cpu"] and export.artifact_kind(out) == "torch"
    assert export.artifact_kind(pt) is None


def test_loader_refusals(ckpt, artifacts, tmp_path):
    """A JAX .ptx is refused with a pointer to the port's export; -quantize
    on an artifact is refused; a batch shape the artifact lacks and a
    platform it was not exported for raise KeyError with JAX's advice."""
    pkl, _, _, d = ckpt
    jax_art = str(d / "jax_refused.ptx")
    jax_export(pkl, jax_art, batch_docs=100, buckets=(16,), platforms=["cpu"])
    with pytest.raises(ValueError, match="ptranking_tpu_torch.export"):
        load_ranker(jax_art, device="cpu")
    path, _ = artifacts["none"]
    with pytest.raises(ValueError, match="-quantize applies when serving a checkpoint"):
        load_ranker(path, quantize="int8", device="cpu")
    served = export.ExportedScorer(path, device="cpu")
    x = np.zeros((5, 16, F), np.float32)
    batch = type("B", (), {"features": x, "mask": np.ones((5, 16), bool)})()
    with pytest.raises(KeyError, match="no exported entry for batch shape"):
        served.predict(batch)

    with open(path, "rb") as f:
        f.read(len(export.MAGIC))
        blob = pickle.load(f)
    blob["entries"] = {k: {"cuda": v["cpu"]} for k, v in blob["entries"].items()}
    cuda_only = str(tmp_path / "cuda_only.pttx")
    with open(cuda_only, "wb") as f:
        f.write(export.MAGIC)
        pickle.dump(blob, f)
    batch = type("B", (), {"features": np.zeros((6, 16, F), np.float32),
                           "mask": np.ones((6, 16), bool)})()
    with pytest.raises(KeyError, match="exported for platforms"):
        export.ExportedScorer(cuda_only, device="cpu").predict(batch)
    with pytest.raises(ValueError, match="unknown platforms"):
        export.export_scorer(ckpt[1], str(tmp_path / "x.pttx"), platforms=["tpu"], device="cpu")


def test_artifact_unpickles_no_class(tmp_path):
    """The artifact's dict may hold builtins only."""
    bad = str(tmp_path / "bad.pttx")
    with open(bad, "wb") as f:
        f.write(export.MAGIC)
        pickle.dump({"version": 1, "cls": collections.OrderedDict}, f)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        export.ExportedScorer(bad, device="cpu")


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1408, 68)])
def test_registered_forward_op_fake(shape):
    """The no-grad forward is a registered op; its fake gives q's shape and
    dtype on meta tensors, so torch.export traces it."""
    B, H, N, d = shape
    op = torch.ops.ptranking_tpu_torch.flash_attn_fwd
    q = torch.empty(shape, device="meta", dtype=torch.bfloat16)
    out = op(q, q, q, torch.empty(B, N, dtype=torch.bool, device="meta"))
    assert out.shape == shape and out.dtype == torch.bfloat16 and out.device.type == "meta"


def test_export_defaults_to_cuda(ckpt, tmp_path, monkeypatch):
    """export_scorer and ExportedScorer default to the card and raise without it."""
    _, pt, _, _ = ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        export.export_scorer(pt, str(tmp_path / "a.pttx"))
