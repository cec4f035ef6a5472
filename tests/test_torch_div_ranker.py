"""The port's DivRanker and resident data against the JAX package's: one
training step from the same params and optimizer state (a JAX .pkl) for
Adam and Adagrad at dropout 0, `evaluate`, `evaluate_per_query` and
`predict`, a resident epoch equal to a streamed one on the CPU bit for bit,
the port's .pt round trip and the ranker's refusals. The k-fold runs and
the CLI are in test_torch_div_evaluator.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.diversification import DivRanker as JaxDivRanker
from ptranking_tpu.diversification import DivScorerConfig as JaxDivScorerConfig
from ptranking_tpu.diversification import losses as jlosses
from ptranking_tpu.diversification import scorers as jsc
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch.data.device_cache import (DivDeviceResidentDataset,
                                                   maybe_div_device_resident)
from ptranking_tpu_torch.diversification import (DivBucketedDataset, DivRanker,
                                                 DivScorerConfig, make_synthetic_div_queries)
from ptranking_tpu_torch.models.convert import div_params_from_jax
from ptranking_tpu_torch.models.scorers import tree_leaves
from ptranking_tpu_torch.train import OptimizerConfig

torch.set_num_threads(1)

D = 8
LR = 1e-3
SMALL = dict(num_features=D, h_dim=16, num_layers=2, ff_dims=(16, 8), encoder_layers=1,
             n_heads=2, dropout=0.0)
METRICS = ("aNDCG", "ERR-IA", "nERR-IA")


def _queries(n=5, seed=3, max_docs=12):
    return make_synthetic_div_queries(num_queries=n, num_features=D, min_docs=5,
                                      max_docs=max_docs, seed=seed)


def _batch():
    """5 queries in one 16-doc batch of 6 rows: the last row all-padded."""
    ds = DivBucketedDataset(_queries(), batch_queries=6)
    (batch,) = list(ds.batches())
    assert int(batch.qids[-1]) == -1
    return batch


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _jax_grads(jr, tr, batch, cfg):
    """The JAX gradient of the step's loss at the ranker's params, as the
    port's leaves."""
    q, d, rm, dm = (jnp.asarray(a) for a in (*batch[:3], batch.doc_mask))

    def loss_of(p):
        mus, vars_, cocos = jsc.div_forward(p, jr.scorer_cfg, q, d, dm, training=True,
                                            key=jax.random.PRNGKey(0))
        fn = jlosses.DIV_LOSSES[tr._loss_key]
        if tr.model_id == "DALETOR":
            return fn(mus, rm, dm, **tr._loss_paras)
        return fn(mus, vars_, rm, dm, cocos=cocos, **tr._loss_paras)

    g = jax.jit(jax.grad(loss_of))(jr.params)
    return [t.numpy() for t in
            tree_leaves(div_params_from_jax(jax.tree_util.tree_map(np.asarray, g), cfg))]


STEP_CASES = [
    ("DALETOR", dict(sf_id="listsf"), {"rt": 10.0, "top_k": 10}, "Adam"),
    ("DivProbRanker", dict(sf_id="pointsf"), {"opt_id": "SuperSoft", "metric": "aNDCG"},
     "Adagrad"),
    ("DivProbRanker", dict(sf_id="listsf_co", K=3),
     {"opt_id": "LambdaPairCLS", "opt_ideal": False}, "Adagrad"),
    ("DivProbRanker", dict(sf_id="pointsf", K=3, cluster=True, limit_delta=2.0),
     {"opt_id": "Portfolio", "gamma": 3.0}, "Adam"),
]


@pytest.mark.parametrize("model_id,over,paras,opt", STEP_CASES,
                         ids=[f"{c[0]}-{c[1]['sf_id']}-{c[3]}" for c in STEP_CASES])
def test_div_step_matches_jax(model_id, over, paras, opt, tmp_path):
    """One step of the port's train_epoch from the JAX ranker's .pkl (params
    and optax state) against the JAX ranker's `_step` on the same batch: the
    loss to 1e-5 and every update within 1e-3 * lr + 1e-4 * |update|. An
    element whose JAX gradient is below 1e-5 of the largest holds rounding
    only (a bias a batch norm follows, the key part of a qkv bias, a shift
    of every mu under a pairwise loss), which the optimizers scale to about
    +-lr: it is held to |update| <= 1.01 lr."""
    cfg = DivScorerConfig(**SMALL, **over)
    jr = JaxDivRanker(model_id, JaxDivScorerConfig(**dataclasses.asdict(cfg)), model_paras=paras,
                      opt_cfg=JaxOptimizerConfig(opt=opt, lr=LR), seed=5).init()
    jr.save(str(tmp_path / "init.pkl"))
    tr = DivRanker(model_id, cfg, model_paras=paras, opt_cfg=OptimizerConfig(opt=opt, lr=LR),
                   seed=5, device="cpu").load(str(tmp_path / "init.pkl"))
    batch = _batch()
    grads = _jax_grads(jr, tr, batch, cfg)
    top = max(float(np.abs(g).max()) for g in grads)
    jr.params, jr.opt_state, loss = jr._step(jr.params, jr.opt_state, jax.random.PRNGKey(0),
                                             *(jnp.asarray(a) for a in batch[:3]),
                                             jnp.asarray(batch.doc_mask))
    want = div_params_from_jax(jax.tree_util.tree_map(np.asarray, jr.params), cfg)

    before = [t.detach().clone() for t in tree_leaves(tr.params)]
    mean_loss, stop = tr.train_epoch([batch], epoch_k=1)
    assert not stop
    np.testing.assert_allclose(mean_loss * 5, float(loss), rtol=1e-5)
    for (name, t), w, old, g in zip(_named_leaves(tr.params), tree_leaves(want), before, grads):
        got, upd = (t.detach() - old).numpy(), (w - old).numpy()
        noise = np.abs(g) < 1e-5 * top
        assert np.all(np.abs(got[noise]) <= 1.01 * LR), name
        np.testing.assert_allclose(got[~noise], upd[~noise], rtol=1e-4, atol=1e-3 * LR,
                                   err_msg=name)


def _trained_pair(tmp_path, sf_id="pointsf"):
    """A JAX ranker and the port's ranker from its .pkl."""
    cfg = DivScorerConfig(**SMALL, sf_id=sf_id)
    ds = DivBucketedDataset(_queries(11, seed=8, max_docs=40), batch_queries=4)
    jr = JaxDivRanker("DALETOR", JaxDivScorerConfig(**dataclasses.asdict(cfg)),
                      opt_cfg=JaxOptimizerConfig(opt="Adagrad", lr=1e-2), seed=2).init()
    jr.save(str(tmp_path / "jax.pkl"))
    tr = DivRanker("DALETOR", cfg, opt_cfg=OptimizerConfig(opt="Adagrad", lr=1e-2), seed=2,
                   device="cpu").load(str(tmp_path / "jax.pkl"))
    return jr, tr, ds


def test_evaluate_and_predict_match_jax(tmp_path):
    """evaluate (streamed and resident), evaluate_per_query and predict of the
    same params: every metric at every cutoff to 1e-5 over 3 buckets."""
    jr, tr, ds = _trained_pair(tmp_path)
    ks = (1, 3, 5, 10, 20)
    want = jr.evaluate(ds, ks=ks)
    for data in (ds, DivDeviceResidentDataset(ds, device="cpu")):
        got = tr.evaluate(data, ks=ks)
        for m in METRICS:
            np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-5, atol=1e-6,
                                       err_msg=m)
    assert 0.0 < got["aNDCG"][2] <= 1.0
    np.testing.assert_allclose(tr.evaluate_per_query(ds.batches(), ks=ks),
                               jr.evaluate_per_query(ds.batches(), ks=ks), rtol=1e-5, atol=1e-6)
    b = next(iter(ds.batches()))
    np.testing.assert_allclose(np.where(b.doc_mask, tr.predict(b).numpy(), 0.0),
                               np.where(b.doc_mask, np.asarray(jr.predict(b)), 0.0),
                               rtol=1e-5, atol=1e-5)
    assert tr.validation(ds, k=5) == pytest.approx(float(got["aNDCG"][2]), rel=1e-6)


def test_resident_epochs_equal_streamed_on_the_cpu():
    """Two epochs from device-resident buckets and two streamed, from the same
    seed with dropout on: the same batches (each gathered from the sentinel
    layout), the same losses and the same params, bit for bit."""
    cfg = DivScorerConfig(**dict(SMALL, dropout=0.1), sf_id="listsf")
    ds = DivBucketedDataset(_queries(13, seed=4, max_docs=40), batch_queries=3, seed=9)
    res = maybe_div_device_resident(ds, device="cpu")
    assert isinstance(res, DivDeviceResidentDataset) and len(res) == len(ds)
    assert maybe_div_device_resident(ds, budget_bytes=10, device="cpu") is ds
    for a, b in zip(res.batches(shuffle=True, epoch=2), ds.batches(shuffle=True, epoch=2)):
        for x, y in zip(a[:5], b[:5]):
            np.testing.assert_array_equal(x.numpy(), y)
        np.testing.assert_array_equal(a.qids, b.qids)
    one, two = (DivRanker("DALETOR", cfg, seed=6, scan_steps=2, device="cpu").init()
                for _ in range(2))
    copies = []
    real = res.index_to_device
    res.index_to_device = lambda idx: copies.append(idx.shape) or real(idx)
    for epoch in (1, 2):
        got = one.train_epoch_resident(res, epoch)
        want = two.train_epoch(ds.batches(shuffle=True, epoch=epoch), epoch)
        assert got == want and not got[1]
    # one index copy a chunk of at most scan_steps (2) batches
    chunks = sum(-(-(-(-len(ds._packed[b][0]) // 3)) // 2) for b in ds._packed)
    assert len(copies) == 2 * chunks and all(s[0] <= 2 for s in copies)
    for x, y in zip(tree_leaves(one.params), tree_leaves(two.params)):
        assert torch.equal(x, y)
    got, want = one.evaluate(res), two.evaluate(ds)
    for m in METRICS:
        np.testing.assert_array_equal(got[m], want[m])


def test_pt_checkpoint_round_trip_and_refusals(tmp_path):
    """save/load of the port's .pt carries params, optimizer and generator
    state: one more step on both rankers gives the same bits. A checkpoint of
    another model id, a .pkl of another config and a mesh are refused."""
    cfg = DivScorerConfig(**dict(SMALL, dropout=0.2), sf_id="listsf_co")
    ds = DivBucketedDataset(_queries(6, seed=1), batch_queries=3)
    a = DivRanker("DivProbRanker", cfg, model_paras={"opt_id": "PairCLS"}, seed=3,
                  device="cpu").init()
    a.train_epoch(ds.batches(), 1)
    a.save(str(tmp_path / "a.pt"))
    b = DivRanker("DivProbRanker", cfg, model_paras={"opt_id": "PairCLS"}, seed=99,
                  device="cpu").load(str(tmp_path / "a.pt"))
    assert a.train_epoch(ds.batches(), 2) == b.train_epoch(ds.batches(), 2)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="checkpoint is for"):
        DivRanker("DALETOR", cfg, device="cpu").load(str(tmp_path / "a.pt"))
    jr = JaxDivRanker("DALETOR", JaxDivScorerConfig(**SMALL, sf_id="pointsf")).init()
    jr.save(str(tmp_path / "j.pkl"))
    with pytest.raises(ValueError, match="expected keys"):
        DivRanker("DALETOR", cfg, device="cpu").load(str(tmp_path / "j.pkl"))
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        DivRanker("DALETOR", cfg, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        DivRanker("DALETOR", cfg, device="cpu").predict(next(iter(ds.batches())))
