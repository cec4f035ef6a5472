"""The port's tensor parallelism on 4 gloo ranks on the CPU, in one group
with two meshes, {data: 2, model: 2} and {data: 1, model: 4}, against the
JAX package's one-device AdhocRanker (its own TP bar, tests/test_parallel.py
:54-72, tightened to losses rtol 1e-4 and nDCG atol 1e-5) and the port's
one-device run:

  * a pointsf with BN under RankMSE and LambdaRank at test_parallel.py's
    shapes (LambdaRank on both meshes); the listsf with its two heads split (model 2)
    and with its attention whole (model 4, n_heads % model != 0); every run
    from the JAX ranker's initial checkpoint, 5 Adam steps;
  * dropout > 0 (a DASALC listsf with dense attention dropout, an AllRank
    listsf with blockwise attention dropout and its position-wise FFN, a
    pointsf whose dropout meets a column-split activation) against the
    port's one-device run from the same seed: the ranks draw the full width
    and keep their block, so the losses agree to rounding;
  * checkpoints: one device's `.pt` and the JAX `.pkl` evaluate on a
    tp=True trainer as on one device, a tp=True trainer's save is full
    tensors that a one-device AdhocRanker scores alike, and resumes bit
    for bit;
  * `ltr.main -mesh data=2,model=2 -tp` in the group: finite nDCG in
    (0, 1], in the run directory the JAX evaluator names; DALETOR on
    {data 1, model 4} gives the one-device run's losses.

One spawn runs every case (tests/torch_parallel_ranks.py::tp_cases)."""

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
from ptranking_tpu_torch.models.scorers import ScorerConfig
from ptranking_tpu_torch.parallel.launch import run_ranks
from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker

torch.set_num_threads(1)

LR = 1e-3
POINTSF = dataclasses.asdict(ranks.pointsf())
LISTSF = dataclasses.asdict(ScorerConfig.default_listsf(ranks.F, ff_dims=(32,),
                                                        encoder_layers=2, dropout=0.0))
# (name, model id, scorer config, mesh): held against the JAX package
# (RankMSE at model 4 runs in the dropout cases, against the port)
JAX_CASES = [("pointsf_rankmse_d2m2", "RankMSE", POINTSF, "d2m2"),
             ("pointsf_lambdarank_d2m2", "LambdaRank", POINTSF, "d2m2"),
             ("pointsf_lambdarank_d1m4", "LambdaRank", POINTSF, "d1m4"),
             ("listsf_heads_split_d2m2", "LambdaRank", LISTSF, "d2m2"),
             ("listsf_attention_whole_d1m4", "LambdaRank", LISTSF, "d1m4")]
# dropout 0.1, from the seed: held against the port's one-device run
DROPOUT_CASES = [("dropout_dasalc_d2m2", "LambdaRank", dict(LISTSF, dropout=0.1), "d2m2"),
                 ("dropout_allrank_d2m2", "LambdaRank",
                  dict(LISTSF, dropout=0.1, encoder_type="AllRank", attn_block_size=8), "d2m2"),
                 ("dropout_pointsf_d1m4", "RankMSE", dict(POINTSF, dropout=0.1, num_layers=3),
                  "d1m4")]
CLI_MESH = {"data": 2, "model": 2}
DIV = {"epochs": 3, "num_queries": 16, "batch_queries": 8}


def _dump_batches(batches, path):
    with open(path, "wb") as f:
        pickle.dump([(np.asarray(b.features), np.asarray(b.labels), np.asarray(b.mask),
                      np.asarray(b.qids)) for b in batches], f)


def _steps(ranker, batches):
    """ranks.STEPS steps, a one-batch epoch each (epoch k = step k), as the
    ranks take them: the mean losses, then nDCG and the params."""
    return [ranker.train_epoch([batches[i % len(batches)]], epoch_k=i + 1)[0]
            for i in range(ranks.STEPS)]


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
    work = tmp_path_factory.mktemp("tp")
    qs = make_synthetic_queries(num_queries=64, num_features=ranks.F, seed=3, min_docs=8,
                                max_docs=16)
    batches = list(BucketedDataset(qs, batch_docs=16 * 16, buckets=(16,)).batches())
    path = str(work / "batches.pkl")
    _dump_batches(batches, path)
    opt = OptimizerConfig(opt="Adam", lr=LR)
    jax_out, single, cases, inits = {}, {}, [], {}
    for name, model_id, kw, mesh in JAX_CASES:
        key = _key(model_id, kw)
        init = inits.setdefault(key, str(work / f"init_{len(inits)}.pkl"))
        if key not in jax_out:
            jr = JaxRanker(model_id, JaxScorerConfig(**kw),
                           opt_cfg=JaxOptimizerConfig(opt="Adam", lr=LR)).init()
            jr.save(init)
            losses = _steps(jr, batches)
            jax_out[key] = {"losses": losses, "metrics": jr.evaluate(batches, ks=ranks.KS)}
            r = AdhocRanker(model_id, ScorerConfig(**kw), opt_cfg=opt, device="cpu").load(init)
            single[key] = {"losses": _steps(r, batches),
                           "metrics": r.evaluate(batches, ks=ranks.KS),
                           "params": ranks._np(r.params)}
        cases.append((name, model_id, kw, mesh, path, init))
    for name, model_id, kw, mesh in DROPOUT_CASES:
        r = AdhocRanker(model_id, ScorerConfig(**kw), opt_cfg=opt, device="cpu").init()
        single[name] = {"losses": _steps(r, batches)}
        cases.append((name, model_id, kw, mesh, path, None))

    # single-device RankNet checkpoints of both packages, and their metrics
    sb = list(BucketedDataset(make_synthetic_queries(num_queries=20, num_features=ranks.F,
                                                     seed=8), batch_docs=100,
                              num_features=ranks.F).batches())
    _dump_batches(sb, str(work / "single_batches.pkl"))
    port = AdhocRanker("RankNet", ranks.pointsf(), opt_cfg=opt, device="cpu").init()
    port.train_epoch(sb, epoch_k=1)
    port.save(str(work / "single.pt"))
    jr = JaxRanker("RankNet", JaxScorerConfig(**POINTSF),
                   opt_cfg=JaxOptimizerConfig(opt="Adam", lr=LR)).init()
    jr.train_epoch(sb, epoch_k=1)
    jr.save(str(work / "single.pkl"))
    want_single = {"pt": port.evaluate(sb, ks=ranks.KS),
                   "pkl": AdhocRanker.from_checkpoint(str(work / "single.pkl"), device="cpu")
                   .evaluate(sb, ks=ranks.KS)}
    ckpts = {"cfg": POINTSF, "batches": str(work / "single_batches.pkl"),
             "pt": str(work / "single.pt"), "pkl": str(work / "single.pkl")}
    cli_out = work / "cli"
    cli_argv = ["-device", "cpu", "-model", "RankMSE", "-debug", "-mesh", "data=2,model=2",
                "-tp", "-dir_output", str(cli_out)]
    out = run_ranks(ranks.tp_cases, 4, (cases, ckpts, cli_argv, str(work), DIV),
                    timeout_s=120, join_timeout_s=300)
    back = AdhocRanker.from_checkpoint(str(work / "tp.pt"), device="cpu")
    back_scores = [back.predict(b).numpy() for b in sb]
    return {"ranks": out, "jax": jax_out, "single": single, "want_single": want_single,
            "back_scores": back_scores, "sb": sb, "cli_out": cli_out, "work": work,
            "div": ranks.run_div(None, **DIV)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _inert(path, model_id, params):
    """Params no score or loss depends on but through rounding: the bias of
    a pointsf layer that batch norm centres, the last layer's bias under
    LambdaRank (a shift of every score), the key third of a qkv bias (a
    shift of every logit of a row). Adam's normalised step turns their
    rounding-sized gradient into steps of up to lr either way."""
    if path[-1] != "b":
        return False
    if path[0] == "point_sf":
        return path[2] < len(params["point_sf"]["layers"]) - 1 or model_id == "LambdaRank"
    if path[0] == "tail_ffnns":
        return path[2] == len(params["tail_ffnns"]["layers"]) - 1 and model_id == "LambdaRank"
    return path[-2] == "qkv"


def _key(model_id, kw):
    return (model_id, tuple(sorted(kw.items())))


@pytest.mark.parametrize("name,model_id,kw,mesh", JAX_CASES)
def test_tp_matches_jax_single_device(runs, name, model_id, kw, mesh):
    """TP against the JAX package's one-device ranker from the same
    checkpoint: losses rtol 1e-4, nDCG atol 1e-5; at least one 2-D weight
    is split over `model` on every rank."""
    want = runs["jax"][_key(model_id, kw)]
    for out in runs["ranks"]:
        got = out[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["nDCG"], np.asarray(want["metrics"]["nDCG"]),
                                   atol=1e-5)
        assert got["split_2d"] >= 1


@pytest.mark.parametrize("name,model_id,kw,mesh", JAX_CASES)
def test_tp_matches_port_single_device(runs, name, model_id, kw, mesh):
    """TP against the port's one-device run: losses rtol 1e-5, params after
    5 Adam steps (joined from the shards) atol 1e-5, inert params within
    Adam's 5 steps of lr; both ranks of a model line hold the same bits."""
    want = runs["single"][_key(model_id, kw)]
    got = runs["ranks"][0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    checked = 0
    for (path, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        if _inert(path, model_id, want["params"]):
            assert np.abs(g - w).max() <= 2 * ranks.STEPS * LR, path
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=str(path))
            checked += 1
    assert checked >= 5
    for out in runs["ranks"][1:]:
        assert out[name]["losses"] == got["losses"]
        for (path, x), (_, y) in zip(_leaves(out[name]["params"]), _leaves(got["params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("name,model_id,kw,mesh", DROPOUT_CASES)
def test_tp_dropout_draws_the_one_device_masks(runs, name, model_id, kw, mesh):
    """Dropout under TP draws the full width (and all heads) from the same
    generator and keeps the rank's block: the one-device losses within
    1e-6 relative."""
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[name]["losses"], runs["single"][name]["losses"],
                                   rtol=1e-6)


@pytest.mark.parametrize("fmt", ["pt", "pkl"])
def test_single_device_checkpoint_loads_into_tp(runs, fmt):
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[f"single_{fmt}"]["nDCG"],
                                   runs["want_single"][fmt]["nDCG"], atol=1e-5)


def test_tp_checkpoint_is_full_and_resumes(runs):
    """A tp=True trainer's checkpoint holds full tensors (one device loads
    and scores it as the mesh does) and resumes on the mesh bit for bit."""
    for got, want, b in zip(runs["ranks"][0]["tp_scores"], runs["back_scores"], runs["sb"]):
        m = np.asarray(b.mask)
        np.testing.assert_allclose(got[m], want[m], atol=1e-5)
    for out in runs["ranks"]:
        assert out["resume"][0] == out["resume"][1]
        for (path, x), (_, y) in zip(*(_leaves(p) for p in out["resume_params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_batch_axes_group_the_ranks_of_a_data_line(runs):
    """The rows split over `data` (with `dcn`, over dcn x data) only: the
    ranks along `model` share a block. Rank r is (data, model) = (r // 2,
    r % 2) on {data 2, model 2} and (dcn, model) = (r // 2, r % 2) on the
    hybrid {dcn 2, model 2}; on {data 1, model 4} every rank has the whole
    batch."""
    for r, out in enumerate(runs["ranks"]):
        g = out["batch_groups"]
        assert g["d2m2"] == ([r % 2, r % 2 + 2], slice(4 * (r // 2), 4 * (r // 2) + 4))
        assert g["dcn2m2"] == ([r % 2, r % 2 + 2], slice(4 * (r // 2), 4 * (r // 2) + 4))
        assert g["d1m4"] == ([r], slice(0, 8))


def test_branch_runs_whole_on_a_model_axis(runs):
    """The diversification branch on {data 1, model 4}: its params whole on
    every model rank, the rows not split; DALETOR's losses and aNDCG are
    the one-device run's, as the JAX package replicates them over `model`."""
    want_losses, want_andcg = runs["div"]
    for out in runs["ranks"]:
        losses, andcg = out["daletor_d1m4"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        np.testing.assert_allclose(andcg, want_andcg, atol=1e-5)


def test_cli_tp_runs_on_four_ranks(runs, tmp_path):
    """`ltr.main -mesh data=2,model=2 -tp` in a group of 4: every rank's CV
    nDCG finite in [0, 1], nDCG@5 in (0, 1] (the JAX package's check of its
    own run), alike on every rank; the run directory is JAX's name."""
    nd = [np.asarray(out["cli"]["nDCG"]) for out in runs["ranks"]]
    assert np.all(np.isfinite(nd[0])) and np.all((nd[0] >= 0) & (nd[0] <= 1))
    assert 0.0 < nd[0][2] <= 1.0
    for x in nd[1:]:
        np.testing.assert_array_equal(x, nd[0])
    (run,) = {os.path.relpath(r, runs["cli_out"]) for r, ds, _ in os.walk(runs["cli_out"])
              if "Fold-1" in ds}
    want = _jax_run_dir(tmp_path, {"mesh": CLI_MESH, "tp": True})
    assert run == want and "Meshd2m2TP" in run
