"""Experiment entry point: python -m ptranking_tpu_torch.ltr -model LambdaRank ...

The port's counterpart of ptranking_tpu/ltr.py, with the same flags and one
more, `-device` (default `cuda`; `cpu` is for tests). An adhoc model id runs
the port's LTREvaluator: k-fold cross-validation with validation, the best
checkpoint of each fold, the stop guard and resume, the training data
device-resident. A tree model id (LightGBMLambdaMART, TPUGBDTLambdaMART)
runs the tree branch's TreeLTREvaluator on the same device, as the JAX
package dispatches it (with -dir_json, -grid, or a point run); where
LightGBM is absent, LightGBMLambdaMART falls back to the native GBDT. A
diversification model id (DALETOR, DivProbRanker) runs the diversification
branch's DivLTREvaluator (default data SyntheticDiv; a point run writes a
TREC run file a fold). An adversarial model id (IRGAN_* / IRFGAN_*) runs
the adversarial branch's AdLTREvaluator (default data SyntheticMQ), as the
JAX package dispatches it.

`-mesh data=D,model=M,seq=S` runs the adhoc, diversification and
adversarial branches over D x M x S ranks (the tree branch ignores the mesh
flags, as in the JAX package): rows split over `data`; with `-tp` the adhoc
scorer's weights split over `model`, with `-pp_stages M` its encoder runs
as an M-stage pipeline over `model` at inference, with `-shard_docs` each
list's docs split over `seq` (context parallelism; `-cp_impl ulysses` for
the all-to-all attention, ring by default); otherwise, and on the branches,
the params stay whole on every model rank and the `seq` ranks repeat their
rows. Under torchrun the process group comes from its environment;
otherwise this entry point starts the ranks itself, as the JAX CLI creates
its devices: gloo ranks for `-device cpu`, NCCL ranks on cards 0..n-1 for
CUDA (more ranks than cards raise), and one rank a one-rank group in this
process. Rank 0 writes the run directory and its result is returned.
Without a mesh the companion flags change nothing, as in the JAX package.
The kernels' library cache is `build/kernels/` unless the environment says
otherwise (utils/compile_cache.py).
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from ptranking_tpu_torch.adversarial import LTR_ADVERSARIAL_MODELS, AdLTREvaluator
from ptranking_tpu_torch.data.prefetch import initialize_distributed
from ptranking_tpu_torch.diversification import DIV_MODELS as LTR_DIV_MODELS
from ptranking_tpu_torch.diversification import DivLTREvaluator
from ptranking_tpu_torch.eval import LTR_ADHOC_MODELS, LTREvaluator
from ptranking_tpu_torch.parallel.launch import one_rank_group, run_ranks
from ptranking_tpu_torch.parallel.mesh import check_mesh_dict, mesh_ranks
from ptranking_tpu_torch.tree import LTR_TREE_MODELS, TreeLTREvaluator
from ptranking_tpu_torch.utils.compile_cache import enable_persistent_cache

ALL_MODELS = list(LTR_ADHOC_MODELS) + LTR_ADVERSARIAL_MODELS + LTR_TREE_MODELS + LTR_DIV_MODELS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ptranking_tpu_torch")
    p.add_argument("-cuda", type=int, default=None, help="CUDA device ordinal")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu (tests only)")
    p.add_argument("-model", type=str, required=True, choices=ALL_MODELS)
    p.add_argument("-debug", "--debug", action="store_true",
                   help="shrink epochs/folds for a quick check")
    p.add_argument("-dir_json", type=str, default=None,
                   help="dir with Data_Eval_ScoringFunction.json")
    p.add_argument("-sf_id", type=str, default="pointsf", choices=["pointsf", "listsf"])
    p.add_argument("-data", dest="data_id", type=str, default=None)
    p.add_argument("-dir_data", type=str, default=None)
    p.add_argument("-dir_output", type=str, default="./output")
    p.add_argument("-grid", action="store_true", help="grid search")
    p.add_argument("-reproduce", action="store_true",
                   help="reload fold-optimal checkpoints and re-evaluate")
    p.add_argument("-epochs", type=int, default=None,
                   help="override epoch count (branch evaluators)")
    # the multi-device layer's flags: read where -mesh is set
    p.add_argument("-mesh", type=str, default=None,
                   help="mesh axis sizes, e.g. 'data=4,model=2' (8 ranks)")
    p.add_argument("-tp", action="store_true",
                   help="tensor-parallel scorer over the mesh's model axis")
    p.add_argument("-shard_docs", action="store_true",
                   help="context parallelism: each list's docs split over the mesh's seq axis")
    p.add_argument("-cp_impl", type=str, default=None, choices=["ring", "ulysses"],
                   help="the attention exchange under -shard_docs (default ring)")
    p.add_argument("-pp_stages", type=int, default=None,
                   help="pipeline stages of the listsf encoder over the model axis")
    p.add_argument("-scan_steps", type=int, default=None,
                   help="train batches an index chunk of the resident epoch")
    p.add_argument("-seed", type=int, default=None, help="base init+shuffle seed (default 137)")
    return p


def parse_mesh_overrides(args) -> dict:
    """-mesh 'data=4,model=2' (and -tp, -shard_docs, ...) -> EvalSetting overrides."""
    ov = {}
    if args.mesh:
        mesh = {}
        for part in args.mesh.split(","):
            ax, _, n = part.partition("=")
            mesh[ax.strip()] = int(n)
        ov["mesh"] = mesh
    if args.tp:
        ov["tp"] = True
    if args.shard_docs:
        ov["shard_docs"] = True
    if args.cp_impl:
        ov["cp_impl"] = args.cp_impl
    if args.pp_stages is not None:
        ov["pp_stages"] = args.pp_stages
    if args.scan_steps is not None:
        ov["scan_steps"] = args.scan_steps
    return ov


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    overrides = parse_mesh_overrides(args)
    mesh = overrides.get("mesh")
    enable_persistent_cache()
    if mesh and args.model not in LTR_TREE_MODELS and not _grouped():
        # a launcher's process (not a rank started below): the axes are
        # checked before any rank starts
        check_mesh_dict(mesh)
        device_type = torch.device(args.device).type
        initialize_distributed(device_type=device_type)  # under torchrun, the group from its environment
        if not _grouped():
            # no launcher made the ranks: start them here
            world = mesh_ranks(mesh)
            if args.cuda is not None and world > 1:
                raise ValueError(f"-cuda picks one card; -mesh {args.mesh} takes cards "
                                 f"0..{world - 1}")
            if world == 1:
                with one_rank_group(device_type, card=args.cuda):
                    return _run(args, overrides)
            return run_ranks(main, world, (argv,), device_type=device_type)[0]
    return _run(args, overrides)


def _run(args, overrides: dict):
    """The run of one process: the whole run, or one rank's share of it."""
    if args.model in LTR_ADVERSARIAL_MODELS:
        evaluator = AdLTREvaluator(device=args.device, cuda=args.cuda, mesh_overrides=overrides)
        if args.dir_json:
            return evaluator.run(debug=args.debug, model_id=args.model,
                                 config_with_json=True, dir_json=args.dir_json)
        if args.grid:
            return evaluator.grid_run(debug=args.debug, model_id=args.model,
                                      data_id=args.data_id or "SyntheticMQ",
                                      dir_data=args.dir_data, dir_output=args.dir_output)
        return evaluator.point_run(model_id=args.model, data_id=args.data_id or "SyntheticMQ",
                                   dir_data=args.dir_data, dir_output=args.dir_output,
                                   debug=args.debug, epochs=args.epochs)
    if args.model in LTR_TREE_MODELS:
        evaluator = TreeLTREvaluator(device=args.device, cuda=args.cuda)
        if args.dir_json:
            return evaluator.run(debug=args.debug, model_id=args.model,
                                 config_with_json=True, dir_json=args.dir_json)
        if args.grid:
            return evaluator.grid_run(debug=args.debug, model_id=args.model,
                                      data_id=args.data_id or "SyntheticMQ",
                                      dir_data=args.dir_data, dir_output=args.dir_output)
        return evaluator.point_run(model_id=args.model, data_id=args.data_id or "SyntheticMQ",
                                   dir_data=args.dir_data, dir_output=args.dir_output,
                                   debug=args.debug)
    if args.model in LTR_DIV_MODELS:
        evaluator = DivLTREvaluator(device=args.device, cuda=args.cuda)
        if args.dir_json:
            return evaluator.run(debug=args.debug, model_id=args.model, sf_id=args.sf_id,
                                 config_with_json=True, dir_json=args.dir_json,
                                 reproduce=args.reproduce)
        if args.grid:
            return evaluator.grid_run(debug=args.debug, model_id=args.model, sf_id=args.sf_id,
                                      data_id=args.data_id or "SyntheticDiv",
                                      dir_data=args.dir_data, dir_output=args.dir_output)
        return evaluator.point_run(model_id=args.model, sf_id=args.sf_id,
                                   data_id=args.data_id or "SyntheticDiv",
                                   dir_data=args.dir_data, dir_output=args.dir_output,
                                   debug=args.debug, epochs=args.epochs, write_run_files=True,
                                   reproduce=args.reproduce, **overrides)
    if args.seed is not None:
        overrides["seed"] = args.seed
    evaluator = LTREvaluator(device=args.device, cuda=args.cuda, mesh_overrides=overrides)
    return evaluator.run(
        debug=args.debug, model_id=args.model, sf_id=args.sf_id,
        config_with_json=args.dir_json is not None, dir_json=args.dir_json,
        data_id=args.data_id or "SyntheticMQ", dir_data=args.dir_data,
        dir_output=args.dir_output, grid_search=args.grid, reproduce=args.reproduce,
    )


if __name__ == "__main__":
    main()
