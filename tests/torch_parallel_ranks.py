"""What the ranks of the port's data-parallel tests run.

Not a test module: `tests/test_torch_parallel_*.py` spawn gloo ranks on the
CPU (ptranking_tpu_torch/parallel/launch.py::run_ranks) and a spawned rank
imports the function it runs from its own module afresh. This module
imports torch, numpy and the port only, never jax: the test modules import
jax and the JAX package, which a rank must not load. Each function runs all
of a test module's cases in one process group and returns their results
(rank 0's are compared in the test; the ranks' params are compared with
each other).
"""

import os
import pickle

import numpy as np
import torch

F = 24
STEPS = 5
KS = (1, 5)


def _np(params):
    from ptranking_tpu_torch.models.scorers import map_params

    return map_params(lambda t: t.detach().cpu().numpy().copy(), params)


def _batches(path):
    from ptranking_tpu_torch.types import RankingBatch

    with open(path, "rb") as f:
        return [RankingBatch(*b) for b in pickle.load(f)]


def _trainer(model_id, cfg, mesh, seed=137, **kw):
    from ptranking_tpu_torch.parallel import DistributedTrainer
    from ptranking_tpu_torch.train.optimizer import OptimizerConfig

    return DistributedTrainer(model_id, cfg, mesh, opt_cfg=OptimizerConfig(opt="Adam", lr=1e-3),
                              seed=seed, device="cpu", **kw)


def pointsf(bn=True):
    from ptranking_tpu_torch.models.scorers import ScorerConfig

    return ScorerConfig(sf_id="pointsf", num_features=F, num_layers=2, h_dim=32, dropout=0.0,
                        apply_tl_af=False, BN=bn)


def trainer_cases(cases, work):
    """Each case (name, model_id, batches file, JAX init checkpoint): 5 steps
    of a DistributedTrainer from the JAX checkpoint, then evaluate; plus the
    mesh's own checks, the resident epoch, resume, a single-device
    checkpoint, the stop guard and per-query rows."""
    import torch.distributed as dist

    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset
    from ptranking_tpu_torch.data.prefetch import shard_for_process
    from ptranking_tpu_torch.parallel import (MeshConfig, batch_sharding, make_hybrid_mesh,
                                              make_mesh, mesh_from_dict, replicated)

    torch.manual_seed(0)
    out = {"rank": dist.get_rank()}
    mesh = make_mesh()
    out["mesh"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names)
    hybrid = make_hybrid_mesh(MeshConfig(data=1), dcn=2)
    out["hybrid"] = (tuple(hybrid.mesh.shape), hybrid.mesh_dim_names)
    out["cached"] = mesh_from_dict({"data": 2}) is mesh_from_dict({"data": 2})
    out["blocks"] = [batch_sharding(mesh).block(n) for n in (7, 8)]
    t = torch.full((3,), float(dist.get_rank() + 1))
    out["replicated"] = replicated(mesh, [t])[0].tolist()
    out["shard"] = shard_for_process(list(range(7)))

    for name, model_id, batches_path, init in cases:
        batches = _batches(batches_path)
        tr = _trainer(model_id, pointsf(), mesh).init()
        tr.load(init)
        losses = [tr.train_step(batches[i % len(batches)]) for i in range(STEPS)]
        out[name] = {"losses": losses, "metrics": tr.evaluate(batches, ks=KS),
                     "params": _np(tr.params)}

    # the resident epoch against the streamed one, from the same params
    qs = make_synthetic_queries(num_queries=40, num_features=F, seed=5, min_docs=4, max_docs=16)
    ds = BucketedDataset(qs, batch_docs=16 * 7, buckets=(16,), num_features=F, seed=3)
    streamed = _trainer("LambdaRank", pointsf(), mesh).init()
    resident = _trainer("LambdaRank", pointsf(), mesh, scan_steps=2).init()
    res = DeviceResidentDataset(ds, device="cpu")
    out["streamed"] = [streamed.train_epoch(ds.batches(shuffle=True, epoch=e), e)[0]
                       for e in (1, 2)]
    out["resident"] = [resident.train_epoch_resident(res, e)[0] for e in (1, 2)]
    out["streamed_params"] = _np(streamed.params)
    out["resident_params"] = _np(resident.params)
    out["eval_streamed"] = streamed.evaluate(ds, ks=KS)
    out["eval_resident"] = streamed.evaluate(res, ks=KS)
    # per-query rows gathered from both ranks
    out["per_query"] = streamed.evaluate_per_query(ds.batches(), ks=KS)

    # resume: a checkpoint written by rank 0, read back by every rank
    path = os.path.join(work, "dp.pt")
    streamed.save(path)
    back = _trainer("LambdaRank", pointsf(), mesh, seed=5).init().load(path)
    b0 = next(iter(ds.batches()))
    out["resume"] = (streamed.train_step(b0), back.train_step(b0))
    out["resume_params"] = (_np(streamed.params), _np(back.params))
    out["files"] = sorted(os.listdir(work))

    # a single-device checkpoint (the port's and the JAX package's) on the mesh
    for fmt in ("pt", "pkl"):
        single = _trainer("RankNet", pointsf(), mesh).init().load(
            os.path.join(work, f"single.{fmt}"))
        out[f"single_{fmt}"] = single.evaluate(_batches(os.path.join(work, "single_batches.pkl")),
                                              ks=KS)

    # mid-training resume through the evaluator on the mesh: a run that saved
    # its train state, run again with resume on, restores it (rank 0 reads
    # it for both ranks) and gives the same CV metrics
    out["kfold_resume"] = [_mesh_kfold(os.path.join(work, "kfold"), resume)
                           for resume in (False, True)]
    out["kfold_states"] = sorted(os.path.relpath(os.path.join(r, f), work)
                                 for r, _, fs in os.walk(os.path.join(work, "kfold"))
                                 for f in fs if f == "train_state.pt")

    # the stop guard: NaN scores stop a check epoch on every rank
    nan = _trainer("LambdaRank", pointsf(), mesh).init()
    with torch.no_grad():
        nan.params["point_sf"]["layers"][0]["linear"]["w"].fill_(float("nan"))
    out["guard"] = (nan.train_epoch(ds.batches(), epoch_k=10),
                    nan.train_epoch_resident(res, epoch_k=10),
                    nan.train_epoch(ds.batches(), epoch_k=1)[1])
    return out


def _mesh_kfold(dir_output, resume):
    """tests/test_distributed_evaluator.py's resume case on a {"data": 2}
    mesh: RankNet, one fold of the debug SyntheticMQ data, 2 epochs, no
    validation, the train state saved each epoch."""
    from ptranking_tpu_torch.eval import LTREvaluator

    ev = LTREvaluator(device="cpu", mesh_overrides={"mesh": {"data": 2}})
    ev.set_settings(True, "RankNet", "pointsf", "SyntheticMQ", None, dir_output, None)
    data_dict = dict(ev.data_setting.default_setting(), fold_num=1, tr_batch_size=1000)
    eval_dict = dict(ev.eval_setting.default_setting(), epochs=2, do_log=False,
                     do_validation=False, save_train_state=True, resume=resume)
    sf_para = ev.sf_setting.default_setting(data_dict["num_features"])
    return ev.kfold_cv_eval(data_dict, eval_dict, sf_para, {"model_id": "RankNet"})


def branch_cases(argv, point_json, init_dir, ad_cfg, div_cfg):
    """`ltr.main(argv)` in this group; the JSON's point run over the mesh
    of its `mesh` setting, each fold's DistributedTrainer from the JAX
    trainer's initial checkpoint of its seed; then a DALETOR DivRanker and
    an IRGAN_Point machine over the mesh."""
    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.eval import LTREvaluator
    from ptranking_tpu_torch.parallel import make_mesh
    from ptranking_tpu_torch.parallel import train as ptrain

    cli = ltr.main(argv)
    real_init = ptrain.DistributedTrainer.init

    def init_from_jax(self):
        real_init(self)
        return self.load(os.path.join(init_dir, f"init_{self.seed}.pkl"))

    ptrain.DistributedTrainer.init = init_from_jax
    try:
        point = LTREvaluator(device="cpu").point_run(debug=True, model_id="RankNet",
                                                     dir_json=point_json)
    finally:
        ptrain.DistributedTrainer.init = real_init
    mesh = make_mesh()
    return {"cli": cli, "point": point, "daletor": run_div(mesh, **div_cfg),
            "irgan": run_machine(mesh, **ad_cfg)}


def run_div(mesh, epochs=3, num_queries=16, batch_queries=8):
    """DALETOR on synthetic diversity data: (per-epoch losses, aNDCG@5)."""
    from ptranking_tpu_torch.diversification import (DivBucketedDataset, DivRanker,
                                                     DivScorerConfig,
                                                     make_synthetic_div_queries)

    qs = make_synthetic_div_queries(num_queries=num_queries, num_features=16, min_docs=12,
                                    max_docs=12, seed=4)
    ds = DivBucketedDataset(qs, batch_queries=batch_queries)
    cfg = DivScorerConfig(sf_id="pointsf", num_features=16, h_dim=16, num_layers=2)
    r = DivRanker("DALETOR", cfg, seed=9, mesh=mesh, device="cpu").init()
    losses = []
    for e in range(1, epochs + 1):
        loss, stop = r.train_epoch(ds.batches(shuffle=True, epoch=e), epoch_k=e)
        assert not stop
        losses.append(loss)
    return losses, r.evaluate(ds, ks=(5,))["aNDCG"]


def run_machine(mesh, model_id="IRGAN_Point", epochs=2, num_queries=32, batch_queries=8):
    """An adversarial machine on fixed-length lists: {G, D: nDCG@5}."""
    from ptranking_tpu_torch.adversarial.evaluator import AD_MACHINES
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.models.scorers import ScorerConfig
    from ptranking_tpu_torch.train.optimizer import OptimizerConfig

    mk = lambda n, s: make_synthetic_queries(num_queries=n, num_features=32, min_docs=16,
                                             max_docs=16, seed=s)
    train = BucketedDataset(mk(num_queries, 5), batch_docs=16 * batch_queries, buckets=(16,))
    test = BucketedDataset(mk(16, 2005), batch_docs=16 * batch_queries, buckets=(16,))
    sf_para = {"scorer": ScorerConfig(sf_id="pointsf", num_features=32, num_layers=2, h_dim=32),
               "optimizer": OptimizerConfig(opt="Adam", lr=1e-3)}
    machine = AD_MACHINES[model_id](sf_para=sf_para, ad_para_dict={}, seed=11, mesh=mesh,
                                    device="cpu")
    for e in range(1, epochs + 1):
        machine.mini_max_train(train_data=list(train.batches(shuffle=True, epoch=e)))
    return {n: p.evaluate(test, ks=(5,))["nDCG"]
            for n, p in (("G", machine.get_generator()), ("D", machine.get_discriminator()))}
