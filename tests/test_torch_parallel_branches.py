"""Data parallelism at the experiment surface and in the branches, W = 2 gloo
ranks on the CPU, as tests/test_distributed_evaluator.py and
tests/test_branch_distributed.py hold the JAX package's:

  * `ltr.main -dir_json ... -mesh data=2` (the JSON's debug grid of RankNet
    on pointsf with BN, dropout 0.1, 2 folds x 5 epochs) against the same
    command without the mesh: every training batch holds an even number of
    queries, so the ranks draw the one-device run's dropout masks and the
    CV metrics agree to rounding;
  * the JSON's point run (2 folds x 2 epochs at dropout 0) with a mesh of
    {"data": 2}, each fold's trainer from the JAX trainer's initial
    checkpoint, against the JAX package's `point_run` on its {"data": 2}
    mesh: CV nDCG within 2e-3 (the JAX package's own mesh bar; the
    packages' samplers differ, dropout is 0);
  * a DALETOR DivRanker and an IRGAN_Point machine over the mesh against
    the port's single-device runs.

One spawn runs every case (tests/torch_parallel_ranks.py)."""

import json

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ptranking_tpu.eval import LTREvaluator as JaxLTREvaluator
from ptranking_tpu.parallel import train as jax_ptrain
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

DIV = {"epochs": 3, "num_queries": 16, "batch_queries": 8}
AD = {"model_id": "IRGAN_Point", "epochs": 2, "num_queries": 32, "batch_queries": 8}


def _write_cfg(root, dir_output, mesh=None):
    """tests/test_distributed_evaluator.py's settings: SyntheticMQ, 2 epochs
    with validation, pointsf with BN at dropout 0, Adam at 1e-3."""
    cfg = {
        "DataSetting": {"data_id": "SyntheticMQ", "dir_data": None, "min_docs": [5],
                        "min_rele": [1], "binary_rele": [False], "unknown_as_zero": [False],
                        "tr_batch_size": [128]},
        "EvalSetting": {"dir_output": str(dir_output), "epochs": 2, "do_validation": True,
                        "vali_k": 5, "vali_metric": "nDCG", "cutoffs": [1, 3, 5, 10],
                        "loss_guided": False, "do_log": False, "log_step": 1,
                        "do_summary": False, "mask": {"mask_label": False}},
        "SFParameter": {"sf_id": "pointsf", "opt": ["Adam"], "lr": [0.001],
                        "pointsf": {"BN": [True], "bn_type": ["BN"], "bn_affine": [True],
                                    "layers": [2], "AF": ["R"], "TL_AF": ["S"],
                                    "apply_tl_af": [False], "dropout": [0.0]}},
    }
    if mesh is not None:
        cfg["EvalSetting"]["mesh"] = mesh
    root.mkdir(parents=True)
    (root / "Data_Eval_ScoringFunction.json").write_text(json.dumps(cfg))
    (root / "RankNetParameter.json").write_text(json.dumps({"RankNet": {"sigma": [1.0]}}))
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_branches")
    init_dir = tmp / "init"
    init_dir.mkdir()
    real_init = jax_ptrain.DistributedTrainer.init

    def init_and_save(self):
        real_init(self)
        self.save(str(init_dir / f"init_{self.seed}.pkl"))
        return self

    jax_ptrain.DistributedTrainer.init = init_and_save
    try:
        jax_perf = JaxLTREvaluator().point_run(
            debug=True, model_id="RankNet",
            dir_json=_write_cfg(tmp / "jax_json", tmp / "jax", mesh={"data": 2}))
    finally:
        jax_ptrain.DistributedTrainer.init = real_init
    argv = ["-device", "cpu", "-model", "RankNet", "-debug",
            "-dir_json", _write_cfg(tmp / "cli_json", tmp / "cli")]
    point_json = _write_cfg(tmp / "point_json", tmp / "point", mesh={"data": 2})
    out = run_ranks(ranks.branch_cases, 2,
                    (argv + ["-mesh", "data=2"], point_json, str(init_dir), AD, DIV),
                    timeout_s=120, join_timeout_s=300)
    return {"ranks": out, "jax": jax_perf, "cli": ltr.main(argv),
            "div": ranks.run_div(None, **DIV), "ad": ranks.run_machine(None, **AD), "tmp": tmp}


def test_cli_mesh_kfold_matches_the_one_device_cli(runs):
    got, want = runs["ranks"][0]["cli"], runs["cli"]
    assert got["nDCG"].shape == (4,) and 0.0 < got["nDCG"][2] <= 1.0
    for m in ("nDCG", "nERR", "AP", "P"):
        np.testing.assert_allclose(got[m], want[m], atol=1e-5, err_msg=m)
    # both ranks return the same CV metrics; rank 0 alone wrote the run, in
    # its own directory beside the one-device run's
    np.testing.assert_array_equal(runs["ranks"][1]["cli"]["nDCG"], got["nDCG"])
    prefixes = sorted(p.parents[2].name for p in (runs["tmp"] / "cli").rglob("Fold-1/*.pt"))
    assert len(prefixes) == 2 and prefixes[1] == prefixes[0] + "_Meshd2"


def test_mesh_point_run_matches_jax_mesh_point_run(runs):
    got, want = runs["ranks"][0]["point"], runs["jax"]
    assert 0.0 < got["nDCG"][2] <= 1.0
    np.testing.assert_allclose(got["nDCG"], np.asarray(want["nDCG"]), atol=2e-3)


def test_daletor_dp_matches_single_device(runs):
    (losses, andcg), (want_losses, want_andcg) = runs["ranks"][0]["daletor"], runs["div"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(andcg, want_andcg, atol=1e-5)


def test_irgan_point_dp_matches_single_device(runs):
    got, want = runs["ranks"][0]["irgan"], runs["ad"]
    for n in ("G", "D"):
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, err_msg=n)
