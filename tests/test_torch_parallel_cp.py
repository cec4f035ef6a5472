"""The port's context parallelism (DistributedTrainer(shard_docs=True)) on 4
gloo ranks on the CPU, in one group with three meshes, {data 2, seq 2},
{seq 4} and {model 2, seq 2}, against the JAX package's one-device
AdhocRanker from its initial checkpoint (its CP bar, tests/test_parallel.py
:75-80 and :91-113, losses rtol 2e-3 and nDCG atol 1e-4, tightened here to
losses rtol 1e-4 and nDCG atol 1e-5) and the port's one-device run:

  * the BN pointsf under LambdaRank (test_cp_doc_axis_sharding_matches) on
    {data 2, seq 2} and {seq 4}; the listsf under ring and Ulysses
    attention; LambdaLoss, WassRank (SinkhornOT) and NeuralNDCG of the CP
    loss zoo; every list of 15 docs, padded to 16 with an all-masked doc;
  * dropout 0.1 (a DASALC listsf with flash attention, which drops nothing
    on either side, and a BN pointsf) against the port's one-device run
    from the same seed: the ranks draw the global batch and keep their
    (rows, docs) block, so the losses agree to rounding (rtol 1e-6);
  * tp=True on {model 2, seq 2}: each model rank one head, the ring over
    `seq`; pp_stages=2 there: CP in training, the pipeline in evaluation;
    WassRank data parallel (shard_docs off: its batch-wide mean,
    label max, score min and EntropicOT's error over the `data` ranks);
  * the resident epoch equal to the streamed one bit for bit; resume from a
    checkpoint bit for bit; predict and per-query rows of whole lists;
  * `ltr.main -mesh data=2,seq=2 -shard_docs` in the group: the CV metrics
    of `-mesh data=2` (the same rows a rank, two ranks started here) within
    1e-5, in the run directory the JAX evaluator names;
  * no tensor that a CP step on {seq 4} saves for its backward has trailing
    dims (N, N) (torch.autograd.graph.saved_tensors_hooks), where the
    one-device step saves [B, H, N, N] and [B, N, N]: the port's form of the
    JAX package's HLO assertions (tests/test_parallel.py:116, 617).

One spawn runs every case (tests/torch_parallel_ranks.py::cp_trainer_cases)."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ptranking_tpu.data import BucketedDataset, make_synthetic_queries
from ptranking_tpu.eval import evaluator as jev
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.models.scorers import ScorerConfig
from ptranking_tpu_torch.parallel import launch
from ptranking_tpu_torch.parallel.launch import run_ranks
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker

torch.set_num_threads(1)

LR = 1e-3
N_DOCS = 15  # lists of 15 docs: padded to 16 over 2 or 4 `seq` ranks
POINTSF = dataclasses.asdict(ranks.pointsf())
POINTSF_NO_BN = dataclasses.asdict(ranks.pointsf(bn=False))
LISTSF = dataclasses.asdict(ScorerConfig.default_listsf(ranks.F, ff_dims=(32,),
                                                        encoder_layers=2, dropout=0.0))
# (name, model id, scorer config, model paras, mesh, trainer kwargs): against JAX
JAX_CASES = [
    ("bn_pointsf_d2s2", "LambdaRank", POINTSF, {}, "d2s2", {}),
    ("bn_pointsf_s4", "LambdaRank", POINTSF, {}, "s4", {}),
    ("listsf_ring_d2s2", "LambdaRank", LISTSF, {}, "d2s2", {"cp_impl": "ring"}),
    ("listsf_ulysses_d2s2", "LambdaRank", LISTSF, {}, "d2s2", {"cp_impl": "ulysses"}),
    ("lambdaloss_d2s2", "LambdaLoss", POINTSF_NO_BN, {"k": 8}, "d2s2", {}),
    ("wassrank_d2s2", "WassRank", POINTSF_NO_BN, {"mode": "SinkhornOT", "sh_itr": 10}, "d2s2",
     {}),
    ("neuralndcg_s4", "NeuralNDCG", POINTSF_NO_BN, {"sinkhorn_iters": 5}, "s4", {}),
    ("tp_listsf_m2s2", "LambdaRank", LISTSF, {}, "m2s2", {"tp": True}),
    # pp_stages with shard_docs: CP in training, the pipeline (whole docs)
    # in the evaluation, as the JAX package does
    ("pp_listsf_m2s2", "LambdaRank", LISTSF, {}, "m2s2", {"pp_stages": 2}),
    # WassRank data parallel (the `seq` ranks repeat their rows): the mean
    # over the whole batch's real queries, its label max, score min and
    # EntropicOT's error span the `data` ranks (fault C6)
    ("wassrank_dp_d2s2", "WassRank", POINTSF_NO_BN, {"mode": "SinkhornOT", "sh_itr": 10},
     "d2s2", {"shard_docs": False}),
    ("wassrank_entropic_ng_dp_d2s2", "WassRank", POINTSF_NO_BN,
     {"mode": "EntropicOT", "smooth_type": "NG", "sh_itr": 10}, "d2s2", {"shard_docs": False}),
]
# dropout 0.1 from the seed: against the port's one-device run
DROPOUT_CASES = [
    ("dropout_listsf_d2s2", "LambdaRank", dict(LISTSF, dropout=0.1, flash_attn=True), {},
     "d2s2", {}),
    ("dropout_pointsf_s4", "RankMSE", dict(POINTSF, dropout=0.1), {}, "s4", {}),
]
CLI_MESH = {"data": 2, "seq": 2}
# the saved-tensor check: a one-layer listsf, lists of 16 docs, 6 a batch
SAVED_N, SAVED_B = 16, 6
SAVED_CFG = dataclasses.asdict(ScorerConfig.default_listsf(ranks.F, ff_dims=(32,),
                                                           encoder_layers=1, dropout=0.0))
SAVED_LOSSES = [("LambdaRank", {}), ("LambdaLoss", {"k": 8}), ("ApproxNDCG", {}),
                ("SoftRank", {}), ("WassRank", {"mode": "SinkhornOT", "sh_itr": 5}),
                ("WassRank", {"mode": "EntropicOT", "sh_itr": 5}),
                ("NeuralNDCG", {"sinkhorn_iters": 3})]


def _dump_batches(batches, path):
    with open(path, "wb") as f:
        pickle.dump([(np.asarray(b.features), np.asarray(b.labels), np.asarray(b.mask),
                      np.asarray(b.qids)) for b in batches], f)


def _steps(ranker, batches):
    return [ranker.train_epoch([batches[i % len(batches)]], epoch_k=i + 1)[0]
            for i in range(ranks.CP_STEPS)]


def _key(model_id, kw, paras):
    return (model_id, tuple(sorted(kw.items())), tuple(sorted(paras.items())))


def _jax_run_dir(root, overrides):
    ev = jev.LTREvaluator(mesh_overrides=overrides)
    ev.set_settings(True, "RankMSE", "pointsf", "SyntheticMQ", None, str(root), None)
    data_dict = ev.data_setting.default_setting()
    eval_dict = ev.eval_setting.default_setting()
    ev.sf_setting.default_setting(data_dict["num_features"])
    ev.model_setting.default_para_dict()
    return os.path.relpath(ev.setup_output(data_dict, eval_dict), root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("cp")
    qs = make_synthetic_queries(num_queries=64, num_features=ranks.F, seed=3, min_docs=8,
                                max_docs=N_DOCS)
    batches = list(BucketedDataset(qs, batch_docs=N_DOCS * 16, buckets=(N_DOCS,)).batches())
    path = str(work / "batches.pkl")
    _dump_batches(batches, path)
    opt = OptimizerConfig(opt="Adam", lr=LR)
    jax_out, cases, inits = {}, [], {}
    for name, model_id, kw, paras, mesh, tkw in JAX_CASES:
        key = _key(model_id, kw, paras)
        init = inits.setdefault(key, str(work / f"init_{len(inits)}.pkl"))
        if key not in jax_out:
            jr = JaxRanker(model_id, JaxScorerConfig(**kw), model_paras=paras,
                           opt_cfg=JaxOptimizerConfig(opt="Adam", lr=LR)).init()
            jr.save(init)
            jax_out[key] = {"losses": _steps(jr, batches),
                            "metrics": jr.evaluate(batches, ks=ranks.KS)}
        cases.append((name, model_id, kw, paras, mesh, tkw, path, init))
    single = {}
    for name, model_id, kw, paras, mesh, tkw in DROPOUT_CASES:
        r = AdhocRanker(model_id, ScorerConfig(**kw), model_paras=paras, opt_cfg=opt,
                        device="cpu").init()
        single[name] = _steps(r, batches)
        cases.append((name, model_id, kw, paras, mesh, tkw, path, None))

    saved_batches = list(BucketedDataset(
        make_synthetic_queries(num_queries=SAVED_B, num_features=ranks.F, seed=4,
                               min_docs=SAVED_N, max_docs=SAVED_N),
        batch_docs=SAVED_N * SAVED_B, buckets=(SAVED_N,)).batches())
    _dump_batches(saved_batches, str(work / "saved.pkl"))
    saved_case = {"cfg": SAVED_CFG, "batches": str(work / "saved.pkl"), "losses": SAVED_LOSSES}
    dense = AdhocRanker("LambdaRank", ScorerConfig(**SAVED_CFG), device="cpu").init()
    dense_saved = ranks._saved_shapes(dense, saved_batches[0])

    cli_out = work / "cli"
    cli_argv = ["-device", "cpu", "-model", "RankMSE", "-debug", "-mesh", "data=2,seq=2",
                "-shard_docs", "-dir_output", str(cli_out)]
    timeouts = launch.DEFAULT_TIMEOUT_S, launch.DEFAULT_JOIN_TIMEOUT_S
    launch.DEFAULT_TIMEOUT_S, launch.DEFAULT_JOIN_TIMEOUT_S = 120.0, 300.0
    try:
        dp = ltr.main(["-device", "cpu", "-model", "RankMSE", "-debug", "-mesh", "data=2",
                       "-dir_output", str(work / "dp")])
    finally:
        launch.DEFAULT_TIMEOUT_S, launch.DEFAULT_JOIN_TIMEOUT_S = timeouts
    out = run_ranks(ranks.cp_trainer_cases, 4, (cases, str(work), cli_argv, saved_case),
                    timeout_s=120, join_timeout_s=300)
    return {"ranks": out, "jax": jax_out, "single": single, "cli_out": cli_out,
            "dp": dp, "dense_saved": dense_saved}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("name,model_id,kw,paras,mesh,tkw", JAX_CASES)
def test_cp_matches_jax_single_device(runs, name, model_id, kw, paras, mesh, tkw):
    """CP against the JAX package's one-device ranker from the same
    checkpoint: losses rtol 1e-4, nDCG atol 1e-5, on every rank; the ranks
    hold the same params (whole on every `seq` rank; joined under tp)."""
    want = runs["jax"][_key(model_id, kw, paras)]
    for out in runs["ranks"]:
        got = out[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["nDCG"], np.asarray(want["metrics"]["nDCG"]),
                                   atol=1e-5)
    first = runs["ranks"][0][name]["params"]
    for out in runs["ranks"][1:]:
        for (path, x), (_, y) in zip(_leaves(out[name]["params"]), _leaves(first)):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("name,model_id,kw,paras,mesh,tkw", DROPOUT_CASES)
def test_cp_dropout_draws_the_one_device_masks(runs, name, model_id, kw, paras, mesh, tkw):
    """Dropout under CP draws the global [B, N, ...] from the same generator
    and keeps the rank's (rows, docs) block: the one-device losses within
    1e-6 relative."""
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[name]["losses"], runs["single"][name], rtol=1e-6)


def test_cp_resident_epoch_equals_streamed(runs):
    """Two epochs over a DeviceResidentDataset (each rank gathers its rows
    and keeps its block of docs) against the same epochs streamed: the same
    losses and params bit for bit, and the same evaluation."""
    for out in runs["ranks"]:
        assert out["resident"] == out["streamed"]
        for (path, x), (_, y) in zip(_leaves(out["resident_params"]),
                                     _leaves(out["streamed_params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))
        for m in ("nDCG", "P"):
            np.testing.assert_allclose(out["eval_resident"][m], out["eval_streamed"][m],
                                       atol=1e-6)


def test_cp_predict_and_per_query_rows_are_whole(runs):
    """predict returns whole lists [B, N] (the `seq` blocks gathered, the
    padded doc cut off), alike on every rank; per-query rows cover every
    real query of the data lines, and their mean is evaluate's."""
    out0 = runs["ranks"][0]
    assert out0["predict"].shape[1] == N_DOCS
    for out in runs["ranks"][1:]:
        np.testing.assert_array_equal(out["predict"], out0["predict"])
    pq = out0["per_query"]["nDCG"]
    assert pq.shape == (40, len(ranks.KS))
    np.testing.assert_allclose(pq.mean(0), out0["eval_streamed"]["nDCG"], atol=1e-6)


def test_cp_checkpoint_resumes(runs):
    for out in runs["ranks"]:
        assert out["resume"][0] == out["resume"][1]
        for (path, x), (_, y) in zip(*(_leaves(p) for p in out["resume_params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_cli_shard_docs_runs_on_four_ranks(runs, tmp_path):
    """`ltr.main -mesh data=2,seq=2 -shard_docs` in a group of 4: the CV
    metrics of `-mesh data=2` within 1e-5 on every rank, in the run
    directory the JAX evaluator names."""
    for out in runs["ranks"]:
        for k, v in runs["dp"].items():
            if k != "elapsed_s":
                np.testing.assert_allclose(out["cli"][k], v, atol=1e-5, err_msg=k)
    (run,) = {os.path.relpath(r, runs["cli_out"]) for r, ds, _ in os.walk(runs["cli_out"])
              if "Fold-1" in ds}
    want = _jax_run_dir(tmp_path, {"mesh": CLI_MESH, "shard_docs": True})
    assert run == want and "Meshd2s2CPring" in run


def test_cp_step_saves_no_full_pair_matrix(runs):
    """No tensor a CP step on {seq 4} saves for its backward has trailing
    dims (N, N), for the listsf under LambdaRank and every loss of the CP
    zoo, where the one-device step saves its [B, H, N, N] attention and
    [B, N, N] pair matrices."""
    full = (SAVED_N, SAVED_N)
    assert any(len(s) >= 3 and s[-2:] == full for s in runs["dense_saved"])
    for out in runs["ranks"]:
        assert len(out["saved"]) == len(SAVED_LOSSES)
        for name, shapes in out["saved"].items():
            assert shapes, name
            bad = [s for s in shapes if len(s) >= 3 and s[-2:] == full]
            assert not bad, (name, bad)
