"""The port's int8 serving path (models/quantize.py, the int8 branch of
models/scorers/nn.py::linear_apply, AdhocRanker.quantized and
load_params_only, score.py -quantize int8) against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.data.dataset import BucketedDataset as JaxBuckets
from ptranking_tpu.data.dataset import make_synthetic_queries
from ptranking_tpu.data.letor import write_letor_file
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.models.quantize import quantize_scorer_params as jax_quantize
from ptranking_tpu.models.scorers.nn import linear_apply as jax_linear
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch.data.dataset import BucketedDataset
from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset
from ptranking_tpu_torch.models.convert import params_from_jax
from ptranking_tpu_torch.models.quantize import (is_quantized, quantize_linear,
                                                 quantize_scorer_params)
from ptranking_tpu_torch.models.scorers import tree_leaves
from ptranking_tpu_torch.models.scorers.nn import int8_matmul, linear_apply
from ptranking_tpu_torch.score import load_ranker, score_file
from ptranking_tpu_torch.train.ranker import AdhocRanker

torch.set_num_threads(1)

F = 24


def _np_leaves(tree):
    """Leaves as numpy arrays in sorted-key order (JAX's pytree order), for a
    JAX tree or the port's."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _np_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _np_leaves(v)]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def _jax_ranker(sf_id, epochs=2):
    """A JAX ranker trained a few epochs (so the weights are not the init's)."""
    cfg = (JaxScorerConfig(sf_id="pointsf", num_features=F) if sf_id == "pointsf"
           else JaxScorerConfig.default_listsf(F, dropout=0.0, encoder_layers=2,
                                                ff_dims=(16, 32)))
    tr = JaxBuckets(make_synthetic_queries(48, num_features=F, seed=1), batch_docs=256)
    r = JaxRanker("LambdaRank", cfg, opt_cfg=JaxOptimizerConfig(lr=1e-3)).init()
    for e in range(epochs):
        r.train_epoch(tr.batches(shuffle=True, epoch=e))
    return r


@pytest.fixture(scope="module")
def rankers(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quantize")
    out = {}
    for sf_id in ("pointsf", "listsf"):
        r = _jax_ranker(sf_id)
        pkl = str(d / f"{sf_id}.pkl")
        r.save(pkl)
        out[sf_id] = (r, pkl)
    return out, d


@pytest.mark.parametrize("sf_id", ["pointsf", "listsf"])
def test_quantize_scorer_params_bit_for_bit(rankers, sf_id):
    """w_q, w_s and b of every linear equal the JAX package's, bit for bit,
    and the tree keeps JAX's structure (norm params untouched)."""
    jr, _ = rankers[0][sf_id]
    want = jax_quantize(jr.params)
    got = quantize_scorer_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jr.params), jr.scorer_cfg, "cpu"))
    assert is_quantized(got) and not is_quantized(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jr.params), jr.scorer_cfg, "cpu"))
    w, g = _np_leaves(want), _np_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_quantize_linear_zero_channel():
    """An all-zero output channel keeps the 1e-12 floor as its scale and
    quantizes to zeros, as in the JAX package."""
    w = np.zeros((5, 3), np.float32)
    w[:, 1] = [1.0, -2.0, 0.5, 0.0, 127.0]
    got = quantize_linear({"w": torch.from_numpy(w), "b": torch.zeros(3)})
    assert got["w_s"][0].item() == np.float32(1e-12)
    assert got["w_q"].dtype == torch.int8 and int(got["w_q"][:, 0].abs().sum()) == 0
    assert got["w_q"][4, 1].item() == 127


def _ulps(got: np.ndarray, want: np.ndarray, dtype) -> float:
    """The largest |got - want| in units of the last place of `want` in the
    output dtype (bf16: 8 significant bits, fp32: 24)."""
    mant = 8 if dtype == "bfloat16" else 24
    want = want.astype(np.float64)
    exp = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny)))
    ulp = 2.0 ** (exp - (mant - 1))
    return float(np.max(np.abs(got.astype(np.float64) - want) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(136, 1), (700, 1), (700, 24), (5, 700), (68, 136)])
def test_int8_linear_within_one_ulp_of_jax(dtype, d_in, d_out):
    """The int8 linear_apply (per-token scales, int8 x int8 -> int32, fp32
    rescale) against JAX's on the same inputs and quantized weights: within
    one unit in the last place of the output dtype (the rescale's products
    may round once apart; the int32 products are exact in both)."""
    rng = np.random.RandomState(d_in * 7 + d_out)
    w = (rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
    b = (0.1 * rng.randn(d_out)).astype(np.float32)
    x = (rng.randn(3, 11, d_in) * rng.gamma(1.0, 1.0, (3, 11, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token: the 1e-12 floor
    jq = jax_quantize({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tq = quantize_linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    if dtype == "bfloat16":  # apply_scorer casts the fp32 leaves under bf16 compute
        jq = {k: (v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v) for k, v in jq.items()}
        tq = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v) for k, v in tq.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jax_linear(jq, jx).astype(jnp.float32))
    got = linear_apply(tq, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == (3, 11, d_out)
    assert _ulps(got.float().numpy(), want, dtype) <= 1.0


@pytest.mark.parametrize("M,K,N", [(1, 136, 1), (5, 700, 3), (40, 24, 16)])
def test_int8_matmul_exact(M, K, N):
    """The plain int8 product is exact (int32), as cuBLASLt's on the card."""
    rng = np.random.RandomState(M + K + N)
    a = rng.randint(-127, 128, (M, K)).astype(np.int8)
    b = rng.randint(-127, 128, (K, N)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def _test_batches(n_queries=24, seed=2):
    qs = make_synthetic_queries(n_queries, num_features=F, seed=seed)
    return JaxBuckets(qs, batch_docs=256), BucketedDataset(qs, batch_docs=256)


@pytest.mark.parametrize("sf_id", ["pointsf", "listsf"])
def test_quantized_predictions_match_jax(rankers, sf_id):
    """The port's quantized ranker (from the JAX checkpoint) against the JAX
    quantized ranker: scores within 1e-2 of their range, correlated above
    0.9999. Activations that differ by an ulp upstream (fp32 summation
    order) can round to the neighbouring int8 level, which moves an output by
    up to about 1/127 of a token's largest activation times the weights'
    scale; with batch norm (pointsf) the batch statistics carry such a step
    to every doc of the batch."""
    jr, pkl = rankers[0][sf_id]
    tr = load_ranker(pkl, quantize="int8", device="cpu")
    jq = jr.quantized()
    jb, tb = _test_batches()
    for a, b in zip(jb.batches(), tb.batches()):
        m = np.asarray(a.mask)
        want = np.asarray(jq.predict(a))[m]
        got = tr.predict(b).numpy()[m]
        scale = float(np.max(np.abs(want))) + 1e-6
        assert float(np.max(np.abs(got - want))) <= 1e-2 * scale
        assert np.corrcoef(want, got)[0, 1] > 0.9999
        # and both stay close to the unquantized scores
        full = np.asarray(jr.predict(a))[m]
        assert np.corrcoef(full, got)[0, 1] > 0.99


def test_quantized_copy_is_inference_only(rankers):
    """quantized() drops the optimizer; training it raises, streamed and
    resident; the original ranker keeps training."""
    _, pkl = rankers[0]["pointsf"]
    r = AdhocRanker.from_checkpoint(pkl, device="cpu")
    q = r.quantized()
    assert q._optimizer is None and r._optimizer is not None
    assert is_quantized(q.params) and not is_quantized(r.params)
    _, tb = _test_batches(8, seed=3)
    with pytest.raises(RuntimeError, match="int8-quantized"):
        q.train_epoch(tb.batches())
    with pytest.raises(RuntimeError, match="int8-quantized"):
        q.train_epoch_resident(DeviceResidentDataset(tb, device="cpu"))
    loss, stop = r.train_epoch(tb.batches())
    assert np.isfinite(loss) and not stop


@pytest.mark.parametrize("fmt", ["pkl", "pt"])
def test_load_params_only(rankers, tmp_path, fmt):
    """load_params_only takes the scorer weights of a .pkl or .pt checkpoint
    into the ranker's own tensors and leaves the optimizer state alone."""
    jr, pkl = rankers[0]["pointsf"]
    path = pkl
    if fmt == "pt":
        path = str(tmp_path / "m.pt")
        AdhocRanker.from_checkpoint(pkl, device="cpu").save(path)
    fresh = AdhocRanker("LambdaRank", jr.scorer_cfg, seed=5, device="cpu").init()
    _, tb = _test_batches(8, seed=3)
    fresh.train_epoch(tb.batches())
    before = [t for t in tree_leaves(fresh.params)]
    state = {k: {n: v.clone() for n, v in s.items()}
             for k, s in fresh._optimizer.state_dict()["state"].items()}
    fresh.load_params_only(path)
    assert all(a is b for a, b in zip(tree_leaves(fresh.params), before))
    for a, b in zip(_np_leaves(fresh.params), _np_leaves(jr.params)):
        np.testing.assert_array_equal(a, b)
    after = fresh._optimizer.state_dict()["state"]
    assert all(torch.equal(after[k][n], v) for k, s in state.items() for n, v in s.items())
    empty = AdhocRanker("LambdaRank", jr.scorer_cfg, device="cpu").load_params_only(path)
    assert empty._optimizer is not None
    with pytest.raises(ValueError, match="expected shape|do not fit"):
        other = AdhocRanker("LambdaRank", jr.scorer_cfg.__class__(
            sf_id="pointsf", num_features=F, h_dim=7), device="cpu").init()
        other.load_params_only(path)


def _run_lines(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    return [(r[0], r[2], int(r[3])) for r in rows], np.array([float(r[4]) for r in rows])


@pytest.mark.parametrize("sf_id", ["pointsf", "listsf"])
def test_score_file_int8_matches_jax(rankers, sf_id):
    """score_file -quantize int8 writes JAX's run: the same qids, docids and
    ranks, line for line, scores within 1e-3 of their range (see
    test_quantized_predictions_match_jax)."""
    from ptranking_tpu.score import score_file as jax_score_file

    (_, pkl), d = rankers[0][sf_id], rankers[1]
    qs = make_synthetic_queries(9, num_features=F, min_docs=3, max_docs=60, seed=4)
    letor = write_letor_file(qs, str(d / f"test_{sf_id}.txt"))
    nj = jax_score_file(pkl, letor, str(d / f"jax_{sf_id}.run"), data_id="MQ2008_Super",
                        quantize="int8")
    nt = score_file(pkl, letor, str(d / f"torch_{sf_id}.run"), data_id="MQ2008_Super",
                    quantize="int8", device="cpu")
    assert nj == nt > 0
    jrank, jscore = _run_lines(d / f"jax_{sf_id}.run")
    trank, tscore = _run_lines(d / f"torch_{sf_id}.run")
    assert trank == jrank
    np.testing.assert_allclose(tscore, jscore, rtol=0,
                               atol=1e-3 * (np.max(np.abs(jscore)) + 1e-6))
    with pytest.raises(ValueError, match="unknown -quantize"):
        load_ranker(pkl, quantize="int4", device="cpu")
