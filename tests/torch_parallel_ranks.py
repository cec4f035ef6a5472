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


# --- tensor and pipeline parallelism: one group of 4 ranks, two meshes ---

TP_MESHES = {"d2m2": (2, 2), "d1m4": (1, 4)}


def _meshes():
    from ptranking_tpu_torch.parallel import MeshConfig, make_mesh

    return {name: make_mesh(MeshConfig(data=d, model=m)) for name, (d, m) in TP_MESHES.items()}


def _cfg(kw):
    from ptranking_tpu_torch.models.scorers import ScorerConfig

    return ScorerConfig(**kw)


def _split_2d(tr):
    """The 2-D weights this rank holds a block of (their shapes differ from
    the full ones)."""
    from ptranking_tpu_torch.models.scorers import tree_leaves

    full = tree_leaves(tr.full_params())
    return sum(1 for a, b in zip(tree_leaves(tr.params), full) if a.dim() == 2 and a.shape != b.shape)


def tp_cases(cases, ckpts, cli_argv, work, div_cfg):
    """Each case (name, model id, scorer config kwargs, mesh name, batches
    file, init checkpoint or None): a tp=True DistributedTrainer on the
    mesh, `STEPS` steps (train_epoch of one batch, epoch k = step k), then
    evaluate; its joined params and how many 2-D weights it splits. Then
    the checkpoints: the single-device `.pt` and `.pkl` (`ckpts`) on a
    tp=True trainer, a tp=True trainer's save (loaded back by the test on
    one device, and resumed here), the CLI under -tp, and DALETOR on the
    {data 1, model 4} mesh (whole params on every model rank)."""
    import torch.distributed as dist

    from ptranking_tpu_torch import ltr

    from ptranking_tpu_torch.parallel import MeshConfig, batch_sharding, make_hybrid_mesh

    torch.manual_seed(0)
    meshes = _meshes()
    out = {"rank": dist.get_rank()}
    # the batch axes' group of each mesh: its ranks, and this rank's block
    hybrid = make_hybrid_mesh(MeshConfig(model=2), dcn=2)
    out["batch_groups"] = {
        name: (dist.get_process_group_ranks(batch_sharding(m).group), batch_sharding(m).block(8))
        for name, m in (*meshes.items(), ("dcn2m2", hybrid))}
    for name, model_id, cfg_kw, mesh_name, batches_path, init in cases:
        batches = _batches(batches_path)
        tr = _trainer(model_id, _cfg(cfg_kw), meshes[mesh_name], tp=True).init()
        if init:
            tr.load(init)
        losses = [tr.train_epoch([batches[i % len(batches)]], epoch_k=i + 1)[0]
                  for i in range(STEPS)]
        out[name] = {"losses": losses, "metrics": tr.evaluate(batches, ks=KS),
                     "params": _np(tr.full_params()), "split_2d": _split_2d(tr)}

    # checkpoints of one device on the mesh, and the mesh's on one device
    sb = _batches(ckpts["batches"])
    for fmt in ("pt", "pkl"):
        tr = _trainer("RankNet", _cfg(ckpts["cfg"]), meshes["d2m2"], tp=True).init()
        out[f"single_{fmt}"] = tr.load(ckpts[fmt]).evaluate(sb, ks=KS)
    tr = _trainer("RankNet", _cfg(ckpts["cfg"]), meshes["d2m2"], tp=True).init()
    tr.train_epoch(sb, epoch_k=1)
    tr.save(os.path.join(work, "tp.pt"))
    out["tp_scores"] = [tr.predict(b).numpy() for b in sb]
    back = _trainer("RankNet", _cfg(ckpts["cfg"]), meshes["d2m2"], tp=True, seed=5).init()
    back.load(os.path.join(work, "tp.pt"))
    out["resume"] = (tr.train_epoch(sb, epoch_k=2), back.train_epoch(sb, epoch_k=2))
    out["resume_params"] = (_np(tr.full_params()), _np(back.full_params()))

    out["cli"] = ltr.main(cli_argv)
    out["daletor_d1m4"] = run_div(meshes["d1m4"], **div_cfg)
    return out


def pp_ep_cases(enc_case, clamp_case, gpipe_case, trainer_case, ep_case):
    """Pipeline stages and expert sharding on both meshes: the listsf
    encoder through `pipeline_encoder_apply` (P = the mesh's model axis),
    the microbatch clamp, `gpipe` against `gpipe_reference`, a
    DistributedTrainer(pp_stages=2)'s predict and evaluate, its guards, and
    a cluster's `div_forward` over the experts' shards."""
    import torch.distributed as dist

    from ptranking_tpu_torch.diversification.scorers import DivScorerConfig, div_forward
    from ptranking_tpu_torch.models.scorers import ScorerConfig
    from ptranking_tpu_torch.parallel import (expert_param_sharding, gpipe,
                                              model_parallel, pipeline_encoder_apply)
    from ptranking_tpu_torch.parallel.pipeline import gpipe_reference

    meshes = _meshes()
    out = {"rank": dist.get_rank()}
    to_t = lambda a: torch.from_numpy(np.asarray(a))
    tree = lambda t: ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                      else [tree(v) for v in t] if isinstance(t, list) else to_t(t))

    x, mask = to_t(enc_case["x"]), to_t(enc_case["mask"])
    with torch.inference_mode():
        for mesh_name, mesh in meshes.items():
            for enc_type, params in enc_case["params"].items():
                out[f"enc_{enc_type}_{mesh_name}"] = pipeline_encoder_apply(
                    tree(params), x, mask, 2, enc_type, mesh, num_microbatches=4).numpy()
            out[f"flash_{mesh_name}"] = pipeline_encoder_apply(
                tree(enc_case["params"]["DASALC"]), x, mask, 2, "DASALC", mesh,
                flash=True).numpy()
        out["clamp"] = [pipeline_encoder_apply(tree(clamp_case["params"]), to_t(cx),
                                               to_t(cm), 2, "DASALC", meshes["d2m2"]).numpy()
                        for cx, cm in clamp_case["inputs"]]
        W, xs = to_t(gpipe_case["W"]), to_t(gpipe_case["xs"])
        stage_fn = lambda w, xb, m: torch.tanh(xb @ w)
        out["gpipe"] = gpipe(stage_fn, W, xs, meshes["d1m4"]).numpy()
        out["gpipe_reference"] = gpipe_reference(stage_fn, W, xs).numpy()

    # DistributedTrainer(pp_stages=2) on data=2, model=2 from the JAX
    # ranker's initial checkpoint: predict and evaluate through the pipeline
    cfg = ScorerConfig(**trainer_case["cfg"])
    batches = _batches(trainer_case["batches"])
    tr = _trainer("LambdaRank", cfg, meshes["d2m2"], pp_stages=2).init().load(
        trainer_case["init"])
    out["pp_scores"] = tr.predict(batches[0]).numpy()
    out["pp_metrics"] = tr.evaluate(batches, ks=KS)
    guards = {}
    pointsf_cfg = pointsf()
    for name, kw, c, mesh in (
            ("tp", {"pp_stages": 2, "tp": True}, cfg, meshes["d2m2"]),
            ("axis", {"pp_stages": 4}, cfg, meshes["d2m2"]),
            ("pointsf", {"pp_stages": 2}, pointsf_cfg, meshes["d2m2"]),
            ("layers", {"pp_stages": 4}, ScorerConfig(**dict(trainer_case["cfg"],
                                                            encoder_layers=2)),
             meshes["d1m4"])):
        try:
            _trainer("LambdaRank", c, mesh, **kw)
            guards[name] = None
        except ValueError as exc:
            guards[name] = str(exc)
    out["guards"] = guards

    # EP: the K-expert cluster, each model rank holding K / M experts
    dcfg = DivScorerConfig(**ep_case["cfg"])
    from ptranking_tpu_torch.models.convert import div_params_from_jax

    full = div_params_from_jax(ep_case["params"], dcfg)
    q, d, m = to_t(ep_case["q"]), to_t(ep_case["d"]), to_t(ep_case["m"])
    with torch.inference_mode():
        for mesh_name, mesh in meshes.items():
            ep = model_parallel(mesh, expert_param_sharding(mesh, full))
            local = ep.shard(full)
            mus, vars_, _ = div_forward(local, dcfg, q, d, m, ep=ep)
            out[f"ep_{mesh_name}"] = (mus.numpy(), vars_.numpy(),
                                      local["point_sf"]["layers"][0]["linear"]["w"].shape[0])
    return out


# --- context parallelism: one group of 4 ranks, meshes {seq 4} and {data 2, seq 2} ---

CP_MESHES = {"s4": (1, 4), "d2s2": (2, 2)}


def _cp_meshes():
    from ptranking_tpu_torch.parallel import MeshConfig, make_mesh

    return {name: make_mesh(MeshConfig(data=d, seq=s)) for name, (d, s) in CP_MESHES.items()}


class _Block:
    """This rank's (rows, docs) block of a [B, N, ...] array on a CP mesh."""

    def __init__(self, mesh, rows, docs):
        from ptranking_tpu_torch.parallel import batch_sharding

        dp = batch_sharding(mesh, shard_docs=True)
        self.dp, self.seq = dp, dp.seq
        self.rows = dp.block(rows)
        n = -(-docs // self.seq.degree)
        self.docs = slice(self.seq.index * n, (self.seq.index + 1) * n)
        self.where = (self.rows.start, self.rows.stop, self.docs.start, self.docs.stop)

    def __call__(self, a, grad=False):
        """The block of numpy `a` ([B, N] or [B, H, N, d]: docs on dim 1 or 2)
        as a tensor (a leaf that takes a gradient with `grad`)."""
        t = torch.from_numpy(np.ascontiguousarray(a))[self.rows]
        t = t[:, self.docs] if t.dim() == 2 else t[:, :, self.docs]
        return t.clone().requires_grad_(grad)


def _value_and_grad(fn, leaf):
    loss = fn(leaf)
    loss.backward()
    return float(loss), leaf.grad.numpy().copy()


def ring_cases(inputs):
    """The ring functions on both meshes, each on this rank's block of the
    test's numpy inputs: attention outputs and q, k, v gradients; the losses'
    values (the rank's data line's) and score gradients (the rank's block);
    with where each block sits in the whole arrays."""
    import torch.distributed as dist

    from ptranking_tpu_torch.losses.listwise import _full_dcg
    from ptranking_tpu_torch.ops import gain, sort_labels_by_scores
    from ptranking_tpu_torch.parallel import cp_plan
    from ptranking_tpu_torch.parallel.collectives import _pad_rows
    from ptranking_tpu_torch.parallel.ot import cp_wass_rank
    from ptranking_tpu_torch.parallel.ring import (ring_approx_ndcg, ring_attention,
                                                   ring_lambda_loss, ring_lambdaloss,
                                                   ring_neural_ndcg, ring_soft_rank,
                                                   ulysses_attention)

    out = {"rank": dist.get_rank()}
    for mesh_name, mesh in _cp_meshes().items():
        cp = cp_plan(mesh)
        res = out[mesh_name] = {}
        att = inputs["attention"]
        blk = _Block(mesh, *att["mask"].shape)
        for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            q, k, v = (blk(att[n], grad=True) for n in ("q", "k", "v"))
            m = blk(att["mask"])
            o = fn(q, k, v, m, cp)
            torch.sum(o ** 2 * m[:, None, :, None]).backward()
            res[impl] = {"out": o.detach().numpy(), "grads": [t.grad.numpy() for t in (q, k, v)],
                         "where": blk.where}

        lam = inputs["lambda"]
        blk = _Block(mesh, *lam["mask"].shape)
        for weighted in (True, False):
            ls, g, m = blk(lam["labels"]), blk(lam["n_gains"]), blk(lam["mask"])
            res[f"lambda_{weighted}"] = (*_value_and_grad(
                lambda s: ring_lambda_loss(s, ls, g, m, cp, weighted=weighted),
                blk(lam["scores"], grad=True)), blk.where)

        def sorted_blocks(s, labels, mask):
            """The trainer's sorted order: the rows gathered and sorted
            whole, the rank's block taken; n_gains over the ideal DCG."""
            s_full = blk.seq.gather_sum(s, 1)
            n_pad = s_full.shape[1]
            s_s, l_s, m_s = sort_labels_by_scores(s_full, _pad_rows(labels, n_pad, 1, 0.0),
                                                  _pad_rows(mask, n_pad, 1, False))
            idcg = torch.clamp(_full_dcg(labels, mask), min=1e-8)[..., None]
            n_gains = torch.where(m_s, gain(torch.where(m_s, l_s, 0.0)) / idcg, 0.0)
            return [blk.seq.block(t, 1) for t in (s_s, l_s, n_gains, m_s)]

        for name, case in inputs["lambdaloss"].items():
            blk = _Block(mesh, *case["mask"].shape)
            rows = blk.rows
            labels = torch.from_numpy(case["labels"])[rows]
            mask = torch.from_numpy(case["mask"])[rows]
            res[name] = (*_value_and_grad(
                lambda s: ring_lambdaloss(*sorted_blocks(s, labels, mask), cp, **case["kw"]),
                blk(case["scores"], grad=True)), blk.where)

        lst = inputs["listwise"]
        blk = _Block(mesh, *lst["mask"].shape)
        labels = torch.from_numpy(lst["labels"])[blk.rows]
        mask = torch.from_numpy(lst["mask"])[blk.rows]
        idcg = torch.clamp(_full_dcg(labels, mask), min=1e-8)[..., None]
        n_gains = blk.seq.block(torch.where(mask, gain(torch.where(mask, labels, 0.0)) / idcg,
                                            0.0), 1)
        m, ls = blk(lst["mask"]), blk(lst["labels"])
        res["approx_ndcg"] = (*_value_and_grad(
            lambda s: ring_approx_ndcg(s, n_gains, m, cp), blk(lst["scores"], grad=True)),
            blk.where)
        for top_k in (None, 5):
            res[f"soft_rank_{top_k}"] = (*_value_and_grad(
                lambda s: ring_soft_rank(s, n_gains, m, cp, delta=2.0, top_k=top_k),
                blk(lst["scores"], grad=True)), blk.where)
        for i, kw in enumerate(inputs["neural_kw"]):
            res[f"neural_{i}"] = (*_value_and_grad(
                lambda s: ring_neural_ndcg(s, ls, m, cp, **kw), blk(lst["scores"], grad=True)),
                blk.where)
        for i, kw in enumerate(inputs["wass_kw"]):
            res[f"wass_{i}"] = (*_value_and_grad(
                lambda s: cp_wass_rank(s, ls, m, cp, **kw), blk(lst["scores"], grad=True)),
                blk.where)
    return out


# --- the context-parallel trainer: one group of 4 ranks, three meshes ---

CP_TRAINER_MESHES = {"d2s2": (2, 1, 2), "s4": (1, 1, 4), "m2s2": (1, 2, 2)}
CP_STEPS = 4


def _cp_trainer_meshes():
    from ptranking_tpu_torch.parallel import MeshConfig, make_mesh

    return {name: make_mesh(MeshConfig(data=d, model=m, seq=s))
            for name, (d, m, s) in CP_TRAINER_MESHES.items()}


def _cp_steps(tr, batches):
    """CP_STEPS one-batch epochs (epoch k = step k): the mean losses."""
    return [tr.train_epoch([batches[i % len(batches)]], epoch_k=i + 1)[0]
            for i in range(CP_STEPS)]


def _saved_shapes(tr, batch):
    """The shapes of every tensor one training step saves for its backward
    (torch.autograd.graph.saved_tensors_hooks around the step)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tr._step(*tr._batch_arrays(batch))
    return shapes


def cp_trainer_cases(cases, work, cli_argv, saved_case):
    """Each case (name, model id, scorer config kwargs, model paras, mesh
    name, trainer kwargs, batches file, JAX init checkpoint or None): a
    DistributedTrainer (shard_docs=True unless the kwargs say otherwise),
    CP_STEPS steps, evaluate, the params. Then the resident epoch against
    the streamed one, resume from a checkpoint, the CLI in the group, and
    the shapes a CP step saves for its backward."""
    import torch.distributed as dist

    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset

    torch.manual_seed(0)
    meshes = _cp_trainer_meshes()
    out = {"rank": dist.get_rank()}
    for name, model_id, cfg_kw, paras, mesh_name, kw, batches_path, init in cases:
        batches = _batches(batches_path)
        tr = _trainer(model_id, _cfg(cfg_kw), meshes[mesh_name], model_paras=paras,
                      **{"shard_docs": True, **kw}).init()
        if init:
            tr.load(init)
        losses = _cp_steps(tr, batches)
        full = tr.full_params() if kw.get("tp") else tr.params
        out[name] = {"losses": losses, "metrics": tr.evaluate(batches, ks=KS),
                     "params": _np(full)}

    # the resident epoch against the streamed one, from the same params
    qs = make_synthetic_queries(num_queries=40, num_features=F, seed=5, min_docs=4, max_docs=15)
    ds = BucketedDataset(qs, batch_docs=15 * 7, buckets=(15,), num_features=F, seed=3)
    mesh = meshes["d2s2"]
    streamed = _trainer("LambdaRank", pointsf(), mesh, shard_docs=True).init()
    resident = _trainer("LambdaRank", pointsf(), mesh, shard_docs=True, scan_steps=2).init()
    res = DeviceResidentDataset(ds, device="cpu")
    out["streamed"] = [streamed.train_epoch(ds.batches(shuffle=True, epoch=e), e)[0]
                       for e in (1, 2)]
    out["resident"] = [resident.train_epoch_resident(res, e)[0] for e in (1, 2)]
    out["streamed_params"] = _np(streamed.params)
    out["resident_params"] = _np(resident.params)
    out["eval_streamed"] = streamed.evaluate(ds, ks=KS)
    out["eval_resident"] = streamed.evaluate(res, ks=KS)
    out["per_query"] = streamed.evaluate_per_query(ds.batches(), ks=KS)
    b0 = next(iter(ds.batches()))
    out["predict"] = streamed.predict(b0).numpy()

    # resume: rank 0 writes a checkpoint, every rank reads it
    path = os.path.join(work, "cp.pt")
    streamed.save(path)
    back = _trainer("LambdaRank", pointsf(), mesh, shard_docs=True, seed=5).init().load(path)
    out["resume"] = (streamed.train_step(b0), back.train_step(b0))
    out["resume_params"] = (_np(streamed.params), _np(back.params))

    out["cli"] = ltr.main(cli_argv)

    # what a CP step on {seq 4} saves for its backward, by loss
    batch = _batches(saved_case["batches"])[0]
    out["saved"] = {}
    for model_id, paras in saved_case["losses"]:
        tr = _trainer(model_id, _cfg(saved_case["cfg"]), meshes["s4"], shard_docs=True,
                      model_paras=paras).init()
        out["saved"][model_id + str(sorted(paras.items()))] = _saved_shapes(tr, batch)
    return out


def seq_branches(div_cfg, ad_cfg):
    """The two branches on a {seq 2} mesh, whose ranks repeat each other's
    rows: DALETOR's (losses, aNDCG@5) and an IRGAN_Point machine's {G, D:
    nDCG@5}."""
    from ptranking_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(seq=2))
    return {"daletor": run_div(mesh, **div_cfg) if div_cfg is not None else None,
            "irgan": run_machine(mesh, **ad_cfg) if ad_cfg is not None else None}
