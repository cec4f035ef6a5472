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
TREC run file a fold). The adversarial model ids and the multi-device flags
are refused until their branches are ported.
"""

from __future__ import annotations

import argparse
import sys

from ptranking_tpu_torch.diversification import DIV_MODELS as LTR_DIV_MODELS
from ptranking_tpu_torch.diversification import DivLTREvaluator
from ptranking_tpu_torch.eval import LTR_ADHOC_MODELS, LTREvaluator
from ptranking_tpu_torch.eval.settings import PARALLEL_KEYS
from ptranking_tpu_torch.tree import LTR_TREE_MODELS, TreeLTREvaluator

# the model ids of the branches the port does not have yet, and the ROADMAP
# queue A item that ports each
LTR_ADVERSARIAL_MODELS = ["IRGAN_Point", "IRGAN_Pair", "IRGAN_List",
                          "IRFGAN_Point", "IRFGAN_Pair", "IRFGAN_List"]
BRANCHES = ((LTR_ADVERSARIAL_MODELS, "adversarial", 7),)
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
    # the multi-device layer's flags: parsed, refused until it is ported
    p.add_argument("-mesh", type=str, default=None,
                   help="mesh axis sizes, e.g. 'data=8' or 'data=4,model=2' (not ported yet)")
    p.add_argument("-tp", action="store_true", help="tensor-parallel scorer (not ported yet)")
    p.add_argument("-shard_docs", action="store_true",
                   help="context-parallel doc axis (not ported yet)")
    p.add_argument("-cp_impl", type=str, default=None, choices=["ring", "ulysses"])
    p.add_argument("-pp_stages", type=int, default=None, help="pipeline stages (not ported yet)")
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    for ids, branch, item in BRANCHES:
        if args.model in ids:
            raise NotImplementedError(
                f"{args.model} belongs to the {branch} branch, which the port does not have "
                f"yet (ROADMAP queue A item {item})")
    overrides = parse_mesh_overrides(args)
    parallel = [k for k in PARALLEL_KEYS if overrides.get(k)]
    if parallel:
        raise NotImplementedError(
            f"{['-' + k for k in parallel]} need the multi-device layer, which the port "
            "does not have yet (ROADMAP queue A item 8)")
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
    main(sys.argv[1:])
