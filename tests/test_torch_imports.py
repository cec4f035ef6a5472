"""The port stands alone: no file of ptranking_tpu_torch/ and not chip_smoke.py
imports jax, optax or the JAX package (nor does the module whose functions
the data-parallel tests' spawned ranks run), and asking for CUDA where
there is none raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "ptranking_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ptranking_tpu_torch")):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _is_forbidden(module: str) -> bool:
    # exact name or a submodule: "ptranking_tpu_torch" is not "ptranking_tpu"
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


# the modules of the later slices, which the walk must reach
SLICE_MODULES = ["adversarial/__init__.py", "adversarial/base.py", "adversarial/evaluator.py",
                 "adversarial/irfgan.py", "adversarial/irgan.py", "adversarial/settings.py",
                 "adversarial/util.py", "utils/chunking.py", "utils/profiling.py",
                 "parallel/__init__.py", "parallel/collectives.py", "parallel/launch.py",
                 "parallel/mesh.py", "parallel/train.py", "parallel/tensor.py",
                 "parallel/pipeline.py", "data/prefetch.py", "parallel/ring.py",
                 "parallel/ot.py", "utils/compile_cache.py"]
# the module of the functions that the spawned ranks of
# tests/test_torch_parallel_*.py run: a rank imports it afresh
RANKS_MODULE = os.path.join(REPO, "tests", "torch_parallel_ranks.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_walk_reaches_the_module(module):
    path = os.path.join(REPO, "ptranking_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not [mod for _, mod in _imports(path) if _is_forbidden(mod)]


def test_spawned_ranks_import_nothing_of_jax():
    """The ranks' module, and the port it imports, load without jax: checked
    by its imports and by importing it in a fresh interpreter."""
    assert not [mod for _, mod in _imports(RANKS_MODULE) if _is_forbidden(mod)]
    code = ("import sys, torch_parallel_ranks, ptranking_tpu_torch.ltr, "
            "ptranking_tpu_torch.parallel.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'ptranking_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(RANKS_MODULE),
                          env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                              filter(None, (REPO, os.environ.get("PYTHONPATH"))))),
                          capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_forbidden_name_matching():
    assert _is_forbidden("ptranking_tpu") and _is_forbidden("ptranking_tpu.models")
    assert _is_forbidden("jax.numpy") and _is_forbidden("optax")
    assert not _is_forbidden("ptranking_tpu_torch.models") and not _is_forbidden("jaxtyping")


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {mod}"
           for p in files for line, mod in _imports(p) if _is_forbidden(mod)]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["ranker", "score_file", "service"])
def test_cuda_request_without_cuda_raises(entry, tmp_path, monkeypatch):
    from ptranking_tpu_torch import resolve_device
    from ptranking_tpu_torch.models import ScorerConfig
    from ptranking_tpu_torch.score import score_file
    from ptranking_tpu_torch.serve import ScoringService
    from ptranking_tpu_torch.train import AdhocRanker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda:0")
    cfg = ScorerConfig.default_pointsf(4, h_dim=8, num_layers=1)
    ckpt = str(tmp_path / "m.pt")
    AdhocRanker("RankMSE", cfg, device="cpu").init().save(ckpt)
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        if entry == "ranker":
            AdhocRanker("RankMSE", cfg)  # device defaults to cuda
        elif entry == "score_file":
            score_file(ckpt, str(tmp_path / "in.txt"), str(tmp_path / "out.txt"))
        else:
            ScoringService(ckpt)


@pytest.mark.parametrize("entry", ["evaluator", "resident", "maybe_resident", "ltr_main",
                                   "div_ranker", "div_resident", "div_evaluator",
                                   "div_ltr_main"])
def test_experiment_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    """The experiment surface and the resident data default to CUDA and
    raise without it, the diversification branch's included."""
    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.device_cache import (DeviceResidentDataset,
                                                       DivDeviceResidentDataset,
                                                       maybe_device_resident)
    from ptranking_tpu_torch.diversification import (DivBucketedDataset, DivLTREvaluator,
                                                     DivRanker, DivScorerConfig,
                                                     make_synthetic_div_queries)
    from ptranking_tpu_torch.eval import LTREvaluator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = BucketedDataset(make_synthetic_queries(3, num_features=4), batch_docs=32)
    div_ds = DivBucketedDataset(make_synthetic_div_queries(3, num_features=4))
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        if entry == "evaluator":
            LTREvaluator()
        elif entry == "resident":
            DeviceResidentDataset(ds)
        elif entry == "maybe_resident":
            maybe_device_resident(ds)
        elif entry == "div_ranker":
            DivRanker("DALETOR", DivScorerConfig(num_features=4))
        elif entry == "div_resident":
            DivDeviceResidentDataset(div_ds)
        elif entry == "div_evaluator":
            DivLTREvaluator()
        elif entry == "div_ltr_main":
            ltr.main(["-model", "DALETOR", "-dir_output", str(tmp_path)])
        else:
            ltr.main(["-model", "RankMSE", "-dir_output", str(tmp_path)])
