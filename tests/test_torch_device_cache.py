"""The port's data layer against the JAX package's: device-resident batches
and index chunks (fp32, bf16 and int8 features), int8 quantisation, the
resident budget, label masking and the prefetch thread; then resident
training and evaluation (`AdhocRanker.train_epoch_resident`, `evaluate` on a
resident dataset) against the JAX ranker from the same params, on the CPU."""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from ptranking_tpu.data import BucketedDataset as JaxBucketedDataset
from ptranking_tpu.data import make_synthetic_queries
from ptranking_tpu.data import random_mask_all_labels as jax_mask_all
from ptranking_tpu.data import random_mask_rele_labels as jax_mask_rele
from ptranking_tpu.data import device_cache as jdc
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch.data import device_cache as tdc
from ptranking_tpu_torch.data.dataset import (BucketedDataset, random_mask_all_labels,
                                              random_mask_rele_labels)
from ptranking_tpu_torch.data.prefetch import prefetch_to_device
from ptranking_tpu_torch.models import scorers as tsc
from ptranking_tpu_torch.train import AdhocRanker

torch.set_num_threads(1)

F = 8
DTYPES = (None, "bfloat16", "int8")
CASES = [(False, 0, False, None), (True, 3, False, None), (True, 3, True, None),
         (True, 2, False, 0.5), (False, 1, True, 0.7)]  # (shuffle, epoch, drop_remainder, percent)


def _queries(n=23, seed=3):
    return make_synthetic_queries(num_queries=n, num_features=F, seed=seed, min_docs=3,
                                  max_docs=40, max_label=4)


def _datasets(n=23, seed=3, batch_docs=64):
    qs = _queries(n, seed)
    return (BucketedDataset(qs, batch_docs=batch_docs, num_features=F),
            JaxBucketedDataset(qs, batch_docs=batch_docs, num_features=F))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or "bfloat16" in str(a.dtype) else a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_resident_batches_equal_jax_and_streamed(dtype, case):
    """Features, labels, mask and qids of every batch equal the JAX package's
    resident batches exactly, for each feature dtype and (shuffle, epoch,
    drop_remainder, percent); labels, mask and qids equal the streamed
    batches', and so do the features in fp32 (in bf16: the streamed
    features rounded to bf16)."""
    shuffle, epoch, drop, percent = case
    ds, jds = _datasets()
    res = tdc.DeviceResidentDataset(ds, dtype=dtype, device="cpu")
    jres = jdc.DeviceResidentDataset(jds, dtype=dtype)
    kw = dict(shuffle=shuffle, epoch=epoch, drop_remainder=drop, percent=percent)
    got, want, streamed = (list(r.batches(**kw)) for r in (res, jres, ds))
    assert len(got) == len(want) == len(streamed) > 0
    for g, w, s in zip(got, want, streamed):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(g.qids, np.asarray(w.qids))
        np.testing.assert_array_equal(g.qids, s.qids)
        np.testing.assert_array_equal(_np(g.labels), s.labels)
        np.testing.assert_array_equal(_np(g.mask), s.mask)
        if dtype is None:
            np.testing.assert_array_equal(_np(g.features), s.features)
        elif dtype == "bfloat16":
            assert g.features.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _np(g.features), torch.from_numpy(s.features).bfloat16().float().numpy())
    assert len(res) == len(ds) and res.num_queries == ds.num_queries


@pytest.mark.parametrize("shuffle,epoch,chunk", [(False, 0, 8), (True, 3, 2), (True, 5, 1)])
def test_epoch_index_chunks_equal_jax(shuffle, epoch, chunk):
    ds, jds = _datasets(n=41, batch_docs=32)
    got = list(tdc.DeviceResidentDataset(ds, device="cpu").epoch_index_chunks(shuffle, epoch,
                                                                             chunk))
    want = list(jdc.DeviceResidentDataset(jds).epoch_index_chunks(shuffle, epoch, chunk))
    assert len(got) == len(want) > 1
    for (b, idx, n), (jb, jidx, jn) in zip(got, want):
        assert (b, n) == (jb, jn) and idx.dtype == np.int64 and idx.shape[0] <= chunk
        np.testing.assert_array_equal(idx, jidx)


def test_quantize_features_equals_jax_and_refuses_non_finite():
    rng = np.random.RandomState(0)
    feats = (rng.randn(5, 16, F) * rng.uniform(0.1, 30, F)).astype(np.float32)
    mask = rng.rand(5, 16) < 0.7
    got = tdc.quantize_features(feats, mask, device="cpu")
    want = jdc.quantize_features(feats, mask)
    assert got.data.dtype == torch.int8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    empty = tdc.quantize_features(feats, np.zeros_like(mask), device="cpu")
    np.testing.assert_array_equal(empty.offset.numpy(), np.zeros(F, np.float32))
    bad = feats.copy()
    bad[1, 2, 3] = np.inf
    mask[1, 2] = True
    with pytest.raises(ValueError, match=r"columns \[3\]"):
        tdc.quantize_features(bad, mask, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_nbytes_and_budget_equal_jax(dtype):
    ds, jds = _datasets()
    n = tdc.packed_nbytes(ds, dtype)
    assert n == jdc.packed_nbytes(jds, dtype) > 0
    assert isinstance(tdc.maybe_device_resident(ds, n, dtype, device="cpu"),
                      tdc.DeviceResidentDataset)
    assert tdc.maybe_device_resident(ds, n - 1, dtype, device="cpu") is ds
    assert isinstance(jdc.maybe_device_resident(jds, n, dtype), jdc.DeviceResidentDataset)
    assert jdc.maybe_device_resident(jds, n - 1, dtype) is jds
    assert tdc.DEFAULT_BUDGET_BYTES == 1 << 30


@pytest.mark.parametrize("masker", ["all", "rele"])
@pytest.mark.parametrize("ratio", [0.2, 0.6])
def test_label_masking_equals_jax(masker, ratio):
    qs = _queries(n=12, seed=5)
    fns = {"all": (random_mask_all_labels, jax_mask_all),
           "rele": (random_mask_rele_labels, jax_mask_rele)}[masker]
    got, want = (fn(qs, ratio, seed=11) for fn in fns)
    assert any(not np.array_equal(a[2], b[2]) for a, b in zip(got, qs))
    for (q, f, l), (jq, jf, jl) in zip(got, want):
        assert q == jq
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)


def test_prefetch_yields_the_batches_on_the_device_and_raises_the_producers_error():
    ds, _ = _datasets()
    batches = list(ds.batches(shuffle=True, epoch=1))
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert isinstance(g.features, torch.Tensor) and g.mask.dtype == torch.bool
        np.testing.assert_array_equal(g.features.numpy(), b.features)
        np.testing.assert_array_equal(g.labels.numpy(), b.labels)
        np.testing.assert_array_equal(g.qids, b.qids)

    def failing():
        yield batches[0]
        raise KeyError("producer")

    with pytest.raises(KeyError, match="producer"):
        list(prefetch_to_device(failing(), device="cpu"))
    before = threading.active_count()
    it = prefetch_to_device(iter(batches * 10), size=1, device="cpu")
    next(it)
    it.close()  # the consumer drops the generator: the thread ends
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=5)
    assert threading.active_count() <= before


# ------------------------------------------------------- resident training

def _pointsf():
    return JaxScorerConfig.default_pointsf(F, h_dim=16, num_layers=2, dropout=0.0, BN=False)


def _listsf():
    return JaxScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 16), dropout=0.0,
                                          apply_tl_af=True)


SCORERS = {"pointsf": _pointsf, "listsf": _listsf}
# deterministic losses; LambdaRank on the fused loss's plain path
LOSSES = {"LambdaRank": {"use_pallas": False}, "ListNet": {}}
EPOCHS = (9, 10)  # the second a check epoch (stop_check_freq 10)
LR = 1e-3
_JAX = {}


def _train_queries():
    """31 lists of 17..32 docs: one bucket of 16 batches of 2, the last a
    remainder padded with the sentinel row, so one shape a chunk of 4."""
    return make_synthetic_queries(num_queries=31, num_features=F, seed=7, min_docs=17,
                                  max_docs=32, max_label=4)


def _jax_resident_run(sf, model_id, tmp_path_factory):
    """The JAX ranker's .pkl at init, then its two resident epochs: the
    losses and the params after them (cached per scorer and loss)."""
    key = (sf, model_id)
    if key not in _JAX:
        d = tmp_path_factory.mktemp(f"res_{sf}_{model_id}")
        jr = JaxRanker(model_id, SCORERS[sf](), model_paras=LOSSES[model_id],
                       opt_cfg=JaxOptimizerConfig(opt="Adagrad", lr=LR), scan_steps=4).init()
        jr.save(str(d / "init.pkl"))
        jres = jdc.DeviceResidentDataset(JaxBucketedDataset(_train_queries(), batch_docs=64,
                                                            num_features=F))
        losses = [jr.train_epoch_resident(jres, e) for e in EPOCHS]
        _JAX[key] = (str(d / "init.pkl"), losses, jax.tree_util.tree_map(np.asarray, jr.params),
                     jr)
    return _JAX[key]


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}[{i}]")]
    return [prefix]


def _jax_leaves(params_np, ranker):
    """The JAX tree's leaves in the port's order."""
    def walk(src, ref):
        if isinstance(ref, dict):
            return [x for k in ref for x in walk(src[k], ref[k])]
        if isinstance(ref, list):
            return [x for s, r in zip(src, ref) for x in walk(s, r)]
        return [np.asarray(src)]

    return walk(params_np, ranker.params)


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("model_id", sorted(LOSSES))
@pytest.mark.parametrize("sf", sorted(SCORERS))
def test_train_epoch_resident_matches_jax(sf, model_id, scan_steps, tmp_path_factory):
    """Two resident epochs (the second a check epoch) from the JAX ranker's
    params and optimizer state: each epoch's loss to 1e-5 relative (seen:
    5e-7), and each parameter tensor's update over the 32 Adagrad steps
    within 1e-4 of its largest element (seen: 2e-5): fp32 sums in other
    orders. The key bias of the listsf is left out: its exact gradient is
    zero (softmax ignores a shift of one query's logits), so both packages
    hold rounding noise there, which Adagrad scales to about +-lr.
    scan_steps changes no value."""
    pkl, want_losses, want_params, _ = _jax_resident_run(sf, model_id, tmp_path_factory)
    ranker = AdhocRanker.from_checkpoint(pkl, device="cpu")
    ranker.scan_steps = scan_steps
    before = [t.detach().clone() for t in tsc.tree_leaves(ranker.params)]
    res = tdc.DeviceResidentDataset(BucketedDataset(_train_queries(), batch_docs=64,
                                                    num_features=F), device="cpu")
    for e, (want_loss, want_stop) in zip(EPOCHS, want_losses):
        loss, stop = ranker.train_epoch_resident(res, e)
        assert stop is False and want_stop is False
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, t, w, old in zip(_names(ranker.params), tsc.tree_leaves(ranker.params),
                               _jax_leaves(want_params, ranker), before):
        got, want = (t.detach() - old).numpy(), w - old.numpy()
        if name.endswith("mhsa.qkv.b"):
            got, want = np.delete(got, np.arange(F, 2 * F)), np.delete(want, np.arange(F, 2 * F))
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_train_epoch_resident_equals_streamed_train_epoch():
    """The resident epoch takes the streamed epoch's batches in the same
    order: the same loss and params, bit for bit, on the CPU."""
    ds, _ = _datasets(n=30, seed=7)
    res = tdc.DeviceResidentDataset(ds, device="cpu")
    cfg = tsc.ScorerConfig(**dataclasses.asdict(_listsf()))
    a, b = (AdhocRanker("ListNet", cfg, device="cpu", scan_steps=3).init() for _ in range(2))
    for e in (1, 2):
        loss_a, _ = a.train_epoch_resident(res, e)
        loss_b, _ = b.train_epoch(ds.batches(shuffle=True, epoch=e), e)
        assert loss_a * res.num_queries == pytest.approx(loss_b * ds.num_queries, rel=1e-6)
    for x, y in zip(tsc.tree_leaves(a.params), tsc.tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_resident_guard_stops_on_poisoned_params():
    """A NaN parameter: the check epoch's guard gives (nan, True), as the JAX
    ranker's; in another epoch the non-finite total does the same."""
    ds, jds = _datasets(n=30, seed=7)
    res = tdc.DeviceResidentDataset(ds, device="cpu")
    ranker = AdhocRanker("ListNet", tsc.ScorerConfig(**dataclasses.asdict(_pointsf())),
                         device="cpu").init()
    assert not ranker.train_epoch_resident(res, 1)[1]
    with torch.no_grad():
        tsc.tree_leaves(ranker.params)[0].fill_(float("nan"))
    for e in (10, 11):
        loss, stop = ranker.train_epoch_resident(res, e)
        assert np.isnan(loss) and stop
    jr = JaxRanker("ListNet", _pointsf()).init()
    jr.params = jax.tree_util.tree_map(lambda a: a * np.nan, jr.params)
    jloss, jstop = jr.train_epoch_resident(jdc.DeviceResidentDataset(jds), 10)
    assert np.isnan(jloss) and jstop


@pytest.mark.parametrize("sf,dtype", [("pointsf", None), ("pointsf", "int8"), ("listsf", None)])
def test_evaluate_resident_matches_jax(sf, dtype, tmp_path_factory):
    """`evaluate` on a resident dataset (EVAL_CHUNK index chunks, each batch
    scored on its own) equals the JAX package's on its resident dataset to
    1e-6, and the port's own streamed evaluate."""
    _, _, _, jr = _jax_resident_run(sf, "ListNet", tmp_path_factory)
    d = tmp_path_factory.mktemp("eval_res")
    jr.save(str(d / "trained.pkl"))
    ranker = AdhocRanker.from_checkpoint(str(d / "trained.pkl"), device="cpu")
    qs = _train_queries()
    ds, jds = (cls(qs, batch_docs=100, num_features=F)
               for cls in (BucketedDataset, JaxBucketedDataset))
    ks = (1, 3, 5, 10, 20)
    got = ranker.evaluate(tdc.DeviceResidentDataset(ds, dtype=dtype, device="cpu"), ks=ks)
    want = jr.evaluate(jdc.DeviceResidentDataset(jds, dtype=dtype), ks=ks)
    for m in want:
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-6, atol=1e-6, err_msg=m)
    if dtype is None:
        streamed = ranker.evaluate(ds, ks=ks)
        for m in want:
            np.testing.assert_allclose(got[m], streamed[m], rtol=1e-6, atol=1e-7, err_msg=m)
    assert got["nDCG"][2] > 0.0
