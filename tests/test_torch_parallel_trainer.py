"""The port's DistributedTrainer at W = 2 gloo ranks on the CPU, against the
port's single-device AdhocRanker and the JAX package's DistributedTrainer
at a mesh of {"data": 2} (the conftest's virtual CPU devices), at the
shapes of tests/test_parallel.py: pointsf with BN under RankMSE and
LambdaRank, and a batch of 7 queries (not divisible by W). Every run starts
from the JAX trainer's initial checkpoint. One spawn of the module's
cases (tests/torch_parallel_ranks.py::trainer_cases) also checks the mesh
built on the process group, the resident epoch against the streamed one,
resume (the trainer's and the evaluator's), single-device checkpoints on the
mesh, per-query rows and the stop guard on every rank."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ptranking_tpu.data import BucketedDataset, make_synthetic_queries
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.parallel import DistributedTrainer as JaxDistributedTrainer
from ptranking_tpu.parallel import MeshConfig as JaxMeshConfig
from ptranking_tpu.parallel import make_mesh as jax_make_mesh
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch.data.prefetch import initialize_distributed, shard_for_process
from ptranking_tpu_torch.parallel.collectives import is_writer
from ptranking_tpu_torch.parallel.launch import free_port, run_ranks
from ptranking_tpu_torch.train.ranker import AdhocRanker

torch.set_num_threads(1)

# (name, model id, queries a batch)
CASES = [("bn_rankmse", "RankMSE", 16), ("bn_lambdarank", "LambdaRank", 16),
         ("odd_rankmse", "RankMSE", 7)]
LR = 1e-3


def _jax_cfg():
    return JaxScorerConfig(**dataclasses.asdict(ranks.pointsf()))


def _dump_batches(batches, path):
    with open(path, "wb") as f:
        pickle.dump([(np.asarray(b.features), np.asarray(b.labels), np.asarray(b.mask),
                      np.asarray(b.qids)) for b in batches], f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ptranking_tpu_torch.train.optimizer import OptimizerConfig

    work = tmp_path_factory.mktemp("dp")
    qs = make_synthetic_queries(num_queries=64, num_features=ranks.F, seed=3, min_docs=8,
                                max_docs=16)
    mesh = jax_make_mesh(JaxMeshConfig(data=2))
    opt = JaxOptimizerConfig(opt="Adam", lr=LR)
    cases, jax_out, single = [], {}, {}
    for name, model_id, b in CASES:
        batches = list(BucketedDataset(qs, batch_docs=16 * b, buckets=(16,)).batches())
        path, init = str(work / f"{name}.pkl"), str(work / f"{name}_init.pkl")
        _dump_batches(batches, path)
        jt = JaxDistributedTrainer(model_id, _jax_cfg(), mesh, opt_cfg=opt).init()
        jt.save(init)
        jax_out[name] = {"losses": [jt.train_step(batches[i % len(batches)])
                                    for i in range(ranks.STEPS)],
                         "metrics": jt.evaluate(batches, ks=ranks.KS)}
        r = AdhocRanker(model_id, ranks.pointsf(), opt_cfg=OptimizerConfig(opt="Adam", lr=LR),
                        device="cpu").load(init)
        single[name] = {"losses": [float(r._step(*r._batch_arrays(batches[i % len(batches)])))
                                   for i in range(ranks.STEPS)],
                        "metrics": r.evaluate(batches, ks=ranks.KS),
                        "params": ranks._np(r.params)}
        cases.append((name, model_id, path, init))

    # single-device RankNet checkpoints of both packages, and their metrics
    sb = list(BucketedDataset(make_synthetic_queries(num_queries=20, num_features=ranks.F,
                                                     seed=8), batch_docs=100,
                              num_features=ranks.F).batches())
    _dump_batches(sb, str(work / "single_batches.pkl"))
    port = AdhocRanker("RankNet", ranks.pointsf(), opt_cfg=OptimizerConfig(opt="Adam", lr=LR),
                       device="cpu").init()
    port.train_epoch(sb, epoch_k=1)
    port.save(str(work / "single.pt"))
    jr = JaxRanker("RankNet", _jax_cfg(), opt_cfg=opt).init()
    jr.train_epoch(sb, epoch_k=1)
    jr.save(str(work / "single.pkl"))
    want_single = {"pt": port.evaluate(sb, ks=ranks.KS),
                   "pkl": AdhocRanker.from_checkpoint(str(work / "single.pkl"), device="cpu")
                   .evaluate(sb, ks=ranks.KS)}

    out = run_ranks(ranks.trainer_cases, 2, (cases, str(work)), timeout_s=120,
                    join_timeout_s=300)
    return {"ranks": out, "jax": jax_out, "single": single, "want_single": want_single}


def test_mesh_is_built_on_the_process_group(runs):
    for r, out in enumerate(runs["ranks"]):
        assert out["rank"] == r
        assert out["mesh"] == ((2, 1, 1), ("data", "model", "seq"))
        assert out["hybrid"] == ((2, 1, 1, 1), ("dcn", "data", "model", "seq"))
        assert out["cached"]
        # 7 rows pad to 8: rank r takes rows [4r, 4r + 4)
        assert out["blocks"] == [slice(4 * r, 4 * r + 4)] * 2
        assert out["replicated"] == [1.0] * 3  # rank 0's values on both ranks
        assert out["shard"] == list(range(7))[r::2]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _inert(path, model_id, last):
    """Params no score or loss depends on: the bias of a layer whose output
    batch norm centres (every hidden layer here), and the last layer's bias
    under a loss that a shift of all scores leaves unchanged (LambdaRank).
    Their gradient is zero up to rounding, which Adam's normalised step
    turns into steps of up to lr either way."""
    return path[-1] == "b" and (path[2] < last or model_id == "LambdaRank")


@pytest.mark.parametrize("name,model_id,b", CASES)
def test_dp_matches_single_device(runs, name, model_id, b):
    """W = 2 against one device from the same checkpoint: losses rtol 1e-5,
    nDCG atol 1e-5, params after 5 Adam steps atol 1e-5 (inert params:
    within Adam's 5 steps of lr)."""
    got, want = runs["ranks"][0][name], runs["single"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["nDCG"], want["metrics"]["nDCG"], atol=1e-5)
    checked, last = 0, len(got["params"]["point_sf"]["layers"]) - 1
    for (path, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        if _inert(path, model_id, last):
            assert np.abs(g - w).max() <= 2 * ranks.STEPS * LR, path
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=str(path))
            checked += 1
    assert checked >= 5


@pytest.mark.parametrize("name,model_id,b", CASES)
def test_dp_matches_jax_data_parallel(runs, name, model_id, b):
    """W = 2 against the JAX DistributedTrainer at {"data": 2}: the JAX
    package's own DP bar (losses rtol 1e-4, nDCG atol 1e-5)."""
    got, want = runs["ranks"][0][name], runs["jax"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["nDCG"], np.asarray(want["metrics"]["nDCG"]),
                               atol=1e-5)


def test_ranks_hold_the_same_bits(runs):
    a, b = runs["ranks"]
    for name, _, _ in CASES:
        assert a[name]["losses"] == b[name]["losses"]
        for (path, x), (_, y) in zip(_leaves(a[name]["params"]), _leaves(b[name]["params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_resident_epoch_equals_streamed(runs):
    """Two epochs over a DeviceResidentDataset (index chunks of 2 batches,
    this rank's columns) against the same epochs streamed: the same losses
    and params bit for bit, and the same evaluation."""
    for out in runs["ranks"]:
        assert out["resident"] == out["streamed"]
        for (path, x), (_, y) in zip(_leaves(out["resident_params"]),
                                     _leaves(out["streamed_params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))
        for m in ("nDCG", "P"):
            np.testing.assert_allclose(out["eval_resident"][m], out["eval_streamed"][m],
                                       atol=1e-6)


def test_per_query_rows_come_from_every_rank(runs):
    out = runs["ranks"][0]
    pq = out["per_query"]["nDCG"]
    assert pq.shape == (40, len(ranks.KS))  # every real query of both ranks' blocks
    np.testing.assert_allclose(pq.mean(axis=0), out["eval_streamed"]["nDCG"], atol=1e-6)
    np.testing.assert_array_equal(pq, runs["ranks"][1]["per_query"]["nDCG"])


def test_resume_round_trip(runs):
    """Rank 0 writes the checkpoint; a trainer of another seed loads it on
    every rank and takes the same next step, bit for bit."""
    for out in runs["ranks"]:
        assert out["resume"][0] == out["resume"][1]
        for (path, x), (_, y) in zip(*(_leaves(p) for p in out["resume_params"])):
            np.testing.assert_array_equal(x, y, err_msg=str(path))
        assert "dp.pt" in out["files"]


def test_mesh_kfold_resumes_mid_training(runs):
    """The evaluator's resume on the mesh: train_state.pt written once (rank
    0), restored on both ranks, the same CV metrics bit for bit."""
    for out in runs["ranks"]:
        first, resumed = out["kfold_resume"]
        for m in ("nDCG", "nERR", "AP", "P"):
            np.testing.assert_array_equal(resumed[m], first[m], err_msg=m)
        assert len(out["kfold_states"]) == 1 and "Meshd2" in out["kfold_states"][0]


@pytest.mark.parametrize("fmt", ["pt", "pkl"])
def test_single_device_checkpoint_loads_on_the_mesh(runs, fmt):
    """The port's `.pt` and the JAX ranker's `.pkl`, written on one device,
    evaluate on the mesh as they do on one device."""
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[f"single_{fmt}"]["nDCG"],
                                   runs["want_single"][fmt]["nDCG"], atol=1e-5)


def test_stop_guard_fires_on_every_rank(runs):
    for out in runs["ranks"]:
        (loss, stop), (res_loss, res_stop), nan_stop = out["guard"]
        assert stop and res_stop and np.isnan(loss) and np.isnan(res_loss)
        # outside a check epoch a non-finite epoch loss stops training, as in
        # the JAX package's DistributedTrainer
        assert nan_stop


def test_initialize_distributed_from_the_environment(monkeypatch):
    """Without a launcher's environment there is no group; with torchrun's
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) the group comes from it (a
    one-rank group here: False, as for a single process), and so it does
    from explicit arguments. The backend follows the run's device type, not
    the host: a `cpu` run gets gloo where CUDA is available too."""
    import torch
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not initialize_distributed() and not dist.is_initialized()
    assert shard_for_process(list(range(5))) == list(range(5)) and is_writer()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        assert not initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                                          device_type="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert not initialize_distributed(device_type="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1 and is_writer()
        assert dist.get_backend() == "gloo"
        assert not initialize_distributed()  # made once
    finally:
        dist.destroy_process_group()
