"""The port's pipeline stages (GPipe over the `model` axis, at inference)
and expert sharding on 4 gloo ranks on the CPU, in one group with two
meshes, {data: 2, model: 2} and {data: 1, model: 4}, against the JAX
package's one-device functions (tests/test_parallel.py's cases and bars):

  * `pipeline_encoder_apply` (DASALC, AttnDIN, AllRank; P = 2 and 4 stages,
    4 microbatches) against JAX's `encoder_apply`, atol 1e-5, also with the
    flash route's attention (blockwise on the CPU);
  * the microbatch clamp at B = 6, 3 and 1;
  * `gpipe` against `gpipe_reference`, atol 1e-6;
  * DistributedTrainer(pp_stages=2) from the JAX ranker's initial
    checkpoint: predict (atol 1e-4) and evaluate (nDCG atol 1e-4) against
    the JAX ranker; the four guards raise where JAX asserts;
  * EP: a K = 4 cluster's `div_forward` over the experts' shards (2 or 1
    experts a rank) against JAX's, mus atol 1e-5, vars rtol 2e-3 atol 1e-4.

One spawn runs every case (tests/torch_parallel_ranks.py::pp_ep_cases)."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ptranking_tpu.data import BucketedDataset, make_synthetic_queries
from ptranking_tpu.diversification.scorers import DivScorerConfig as JaxDivScorerConfig
from ptranking_tpu.diversification.scorers import div_forward as jax_div_forward
from ptranking_tpu.diversification.scorers import init_div_scorer as jax_init_div_scorer
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.models.scorers import listsf as jax_listsf
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch.models.scorers import ScorerConfig
from ptranking_tpu_torch.parallel.launch import run_ranks
from ptranking_tpu_torch.parallel.pipeline import microbatches

torch.set_num_threads(1)

ENC_TYPES = ("DASALC", "AttnDIN", "AllRank")
MESHES = tuple(ranks.TP_MESHES)
TRAINER_CFG = dataclasses.asdict(ScorerConfig.default_listsf(ranks.F, ff_dims=(32,),
                                                             encoder_layers=2, dropout=0.0))
EP_CFG = {"sf_id": "pointsf", "num_features": 10, "K": 4, "cluster": True}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp")
    # tests/test_parallel.py:202-236 and :350-372: F = 8, B = 8, N = 16, 4 layers
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16, 8).astype(np.float32)
    mask = np.ones((8, 16), bool)
    mask[1, 10:] = False
    enc = {t: jax_listsf.encoder_init(jax.random.PRNGKey(0), 8, 4, t) for t in ENC_TYPES}
    enc_want = {t: np.asarray(jax_listsf.encoder_apply(p, jnp.asarray(x), jnp.asarray(mask), 2,
                                                       t, drop_rate=0.0, training=False))
                for t, p in enc.items()}
    enc_case = {"x": x, "mask": mask, "params": {t: _np_tree(p) for t, p in enc.items()}}
    # :776-790: B = 6, 3, 1 at 5 docs, 2 layers
    key = jax.random.PRNGKey(0)
    cparams = jax_listsf.encoder_init(key, 8, 2, "DASALC")
    inputs, clamp_want = [], []
    for B in (6, 3, 1):
        cx = jax.random.normal(key, (B, 5, 8))
        cm = jnp.ones((B, 5), bool).at[0, 3:].set(False)
        inputs.append((np.asarray(cx), np.asarray(cm)))
        clamp_want.append(np.asarray(jax_listsf.encoder_apply(cparams, cx, cm, 2, "DASALC",
                                                              drop_rate=0.0, training=False)))
    clamp_case = {"params": _np_tree(cparams), "inputs": inputs}
    # :201-215: P = 4 stages, 6 microbatches
    W = (rng.randn(4, 8, 8) * 0.3).astype(np.float32)
    xs = rng.randn(6, 4, 16, 8).astype(np.float32)
    # :533-559: the pp trainer against one device
    qs = make_synthetic_queries(num_queries=32, num_features=ranks.F, seed=3, min_docs=8,
                                max_docs=16)
    batches = list(BucketedDataset(qs, batch_docs=16 * 16, buckets=(16,)).batches())
    with open(work / "batches.pkl", "wb") as f:
        pickle.dump([(np.asarray(b.features), np.asarray(b.labels), np.asarray(b.mask),
                      np.asarray(b.qids)) for b in batches], f)
    jr = JaxRanker("LambdaRank", JaxScorerConfig(**TRAINER_CFG),
                   opt_cfg=JaxOptimizerConfig(opt="Adam", lr=1e-3)).init()
    jr.save(str(work / "init.pkl"))
    trainer_want = {"scores": np.asarray(jr.predict(batches[0])),
                    "metrics": jr.evaluate(batches, ks=ranks.KS), "mask": batches[0].mask}
    trainer_case = {"cfg": TRAINER_CFG, "batches": str(work / "batches.pkl"),
                    "init": str(work / "init.pkl")}
    # :147-180: the K = 4 cluster
    dcfg = JaxDivScorerConfig(**EP_CFG)
    dparams = jax_init_div_scorer(jax.random.PRNGKey(0), dcfg)
    q = rng.randn(8, 10).astype(np.float32)
    d = rng.randn(8, 16, 10).astype(np.float32)
    m = np.ones((8, 16), bool)
    m[0, 10:] = False
    mus, vars_, _ = jax_div_forward(dparams, dcfg, jnp.asarray(q), jnp.asarray(d),
                                    jnp.asarray(m))
    ep_case = {"cfg": EP_CFG, "params": _np_tree(dparams), "q": q, "d": d, "m": m}
    out = run_ranks(ranks.pp_ep_cases, 4,
                    (enc_case, clamp_case, {"W": W, "xs": xs}, trainer_case, ep_case),
                    timeout_s=120, join_timeout_s=300)
    return {"ranks": out, "enc": enc_want, "clamp": clamp_want, "trainer": trainer_want,
            "ep": (np.asarray(mus), np.asarray(vars_))}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("enc_type", ENC_TYPES)
def test_pipeline_encoder_matches_jax(runs, enc_type, mesh):
    """Every model rank holds the last stage's outputs: JAX's one-device
    encoder within 1e-5."""
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[f"enc_{enc_type}_{mesh}"], runs["enc"][enc_type],
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_pipeline_flash_route_matches_jax(runs, mesh):
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[f"flash_{mesh}"], runs["enc"]["DASALC"], atol=1e-5)


def test_pipeline_microbatches_clamp_to_batch(runs):
    assert [microbatches(B, 4) for B in (8, 6, 3, 1)] == [4, 3, 3, 1]
    for out in runs["ranks"]:
        for got, want in zip(out["clamp"], runs["clamp"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gpipe_matches_sequential_oracle(runs):
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["gpipe"], out["gpipe_reference"], atol=1e-6)


def test_pp_stages_predict_and_evaluate_match_jax(runs):
    want = runs["trainer"]
    m = np.asarray(want["mask"])
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["pp_scores"][m], want["scores"][m], atol=1e-4)
        np.testing.assert_allclose(out["pp_metrics"]["nDCG"],
                                   np.asarray(want["metrics"]["nDCG"]), atol=1e-4)


@pytest.mark.parametrize("guard,match", [("tp", "both claim"), ("axis", "model axis"),
                                         ("pointsf", "listsf encoder"),
                                         ("layers", "do not divide")])
def test_pp_stages_guards(runs, guard, match):
    for out in runs["ranks"]:
        assert out["guards"][guard] is not None and match in out["guards"][guard]


@pytest.mark.parametrize("mesh,local_k", [("d2m2", 2), ("d1m4", 1)])
def test_expert_sharded_cluster_matches_jax(runs, mesh, local_k):
    mus_want, vars_want = runs["ep"]
    for out in runs["ranks"]:
        mus, vars_, k = out[f"ep_{mesh}"]
        assert k == local_k
        np.testing.assert_allclose(mus, mus_want, atol=1e-5)
        np.testing.assert_allclose(vars_, vars_want, rtol=2e-3, atol=1e-4)
