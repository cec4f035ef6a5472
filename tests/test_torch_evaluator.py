"""The port's experiment surface against the JAX package's: the settings
(grids and run-directory names from configs/*.json and the built-in
defaults), CVTape, a 2-fold x 2-epoch `kfold_cv_eval` on the debug
SyntheticMQ data and on small LETOR files from the same initial params,
an interrupted run resumed to the same bits, `python -m
ptranking_tpu_torch.ltr` on the CPU, and the multi-device flags as the JAX
package reads them: without `-mesh` they change nothing, the tree branch
ignores them, `-mesh data=W` runs W data-parallel ranks, a `model` axis
runs with `-tp`, `-pp_stages` or whole params (ROADMAP queue A item 8b),
and a `seq` axis with `-shard_docs` runs context parallelism (item 8c), or,
without it and on the branches, repeats each rank's rows."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptranking_tpu.adversarial import AdLTREvaluator as JaxAdLTREvaluator
from ptranking_tpu.data import make_synthetic_queries
from ptranking_tpu.data.letor import write_letor_file
from ptranking_tpu.diversification import DivLTREvaluator as JaxDivLTREvaluator
from ptranking_tpu.eval import evaluator as jev
from ptranking_tpu.eval import tapes as jtapes
from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu.types import LabelType as JaxLabelType
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.eval import evaluator as tev
from ptranking_tpu_torch.eval import tapes as ttapes
from ptranking_tpu_torch.eval.settings import SFSetting
from ptranking_tpu_torch.parallel import launch
from ptranking_tpu_torch.train.ranker import AdhocRanker, read_checkpoint
from ptranking_tpu_torch.types import LabelType

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
METRICS = ("nDCG", "nERR", "AP", "P")


@pytest.fixture(autouse=True)
def _short_rank_timeouts(monkeypatch):
    """The ranks that `ltr.main -mesh data=W` starts wait at most 120 s in
    a collective and 300 s in all: a deadlock fails its test in minutes."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launch, "DEFAULT_JOIN_TIMEOUT_S", 300.0)


def _asdict(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _settings_walk(ev, tmp, debug, model_id, sf_id, dir_json):
    """Every grid point of an evaluator's settings as plain dicts, with the
    run directory each gives (relative to `tmp`)."""
    ev.set_settings(debug, model_id, sf_id, "SyntheticMQ", None, str(tmp), dir_json)
    out = []
    for data_dict in ev.data_setting.grid_search():
        for eval_dict in ev.eval_setting.grid_search():
            for sf_para in ev.sf_setting.grid_search(data_dict["num_features"]):
                for model_para in ev.model_setting.grid_search():
                    run = ev.setup_output(data_dict, dict(eval_dict, dir_output=str(tmp)))
                    out.append((dict(data_dict, label_type=str(data_dict["label_type"])),
                                {k: v for k, v in eval_dict.items() if k != "dir_output"},
                                {k: _asdict(v) for k, v in sf_para.items()}, dict(model_para),
                                os.path.relpath(run, tmp)))
    defaults = (ev.data_setting.default_setting(), ev.eval_setting.default_setting())
    sf = ev.sf_setting.default_setting(defaults[0]["num_features"])
    out.append(({k: str(v) for k, v in defaults[0].items()},
                {k: v for k, v in defaults[1].items() if k != "dir_output"},
                {k: _asdict(v) for k, v in sf.items()}, ev.model_setting.default_para_dict()))
    return out


@pytest.mark.parametrize("dir_json", [None, CONFIGS])
@pytest.mark.parametrize("sf_id", ["pointsf", "listsf"])
@pytest.mark.parametrize("model_id", tev.LTR_ADHOC_MODELS)
def test_settings_and_run_names_equal_jax(model_id, sf_id, dir_json, tmp_path):
    """configs/Data_Eval_ScoringFunction.json with the <Model>Parameter.json
    that exists (LambdaRank's, RankNet's), or the built-in defaults: the same
    data, eval, scorer and model grids, defaults and run directories."""
    for debug in (True, False):
        got = _settings_walk(tev.LTREvaluator(device="cpu"), tmp_path / "port", debug,
                             model_id, sf_id, dir_json)
        want = _settings_walk(jev.LTREvaluator(), tmp_path / "jax", debug, model_id, sf_id,
                              dir_json)
        assert got == want and len(got) > 1


class _StubRanker:
    """Fixed metrics by fold: what CVTape reads of a ranker."""

    def __init__(self, seed, n_queries=5, ks=(1, 3, 5)):
        rng = np.random.RandomState(seed)
        self.pq = {m: rng.rand(n_queries, len(ks)) for m in METRICS}

    def evaluate(self, batches, ks):
        return {m: v.mean(axis=0) for m, v in self.pq.items()}

    def evaluate_per_query(self, batches, ks):
        return self.pq


@pytest.mark.parametrize("reproduce", [False, True])
def test_cv_tape_means_equal_jax(reproduce, tmp_path):
    ks = [1, 3, 5]
    tapes = []
    for mod, name in ((ttapes, "port"), (jtapes, "jax")):
        d = tmp_path / name
        d.mkdir()
        tape = mod.CVTape("RankMSE", 3, ks, True, reproduce=reproduce, dir_run=str(d))
        for fold in (1, 2, 3):
            tape.fold_evaluation(_StubRanker(fold), [], fold)
        tapes.append((tape.get_cv_performance(), d))
    (got, d_port), (want, d_jax) = tapes
    for m in METRICS:
        np.testing.assert_array_equal(got[m], want[m])
    if reproduce:
        for short in ("p", "ap", "nerr", "ndcg"):
            name = f"RankMSE_all_fold_{short}_at_ks_per_q.np"
            with open(d_port / name, "rb") as f, open(d_jax / name, "rb") as g:
                np.testing.assert_array_equal(pickle.load(f), pickle.load(g))


# ------------------------------------------------------------ k-fold runs

def _from_jax_ranker(tmp_path):
    """The port's AdhocRanker whose init() takes the JAX ranker's params and
    optimizer state of the same seed (through its .pkl)."""

    class FromJax(AdhocRanker):
        def init(self):
            jr = JaxRanker(self.model_id, JaxScorerConfig(**dataclasses.asdict(self.scorer_cfg)),
                           model_paras=self.model_paras,
                           label_type=JaxLabelType[self.label_type.name],
                           opt_cfg=JaxOptimizerConfig(**dataclasses.asdict(self.opt_cfg)),
                           seed=self.seed).init()
            path = str(tmp_path / f"init_{self.seed}.pkl")
            jr.save(path)
            return self.restore(read_checkpoint(path))

    return FromJax


def _letor_dir(root):
    """Two folds of small MQ2008-shaped LETOR files (46 features, 10..30
    docs a query)."""
    for fold in (1, 2):
        for i, split in enumerate(("train", "vali", "test")):
            qs = make_synthetic_queries(num_queries=24, num_features=46, min_docs=10,
                                        max_docs=30, seed=100 * fold + i)
            write_letor_file(qs, os.path.join(root, f"Fold{fold}", f"{split}.txt"))
    return str(root)


def _kfold(ev, data_id, dir_data, dir_output, resume=False):
    """RankMSE on the default pointsf (dropout 0), 2 folds of the debug
    settings, 2 epochs, validation on; batches of 1,000 docs, so that each
    bucket of each split is one batch (one shape a bucket for the JAX
    package to compile)."""
    ev.set_settings(True, "RankMSE", "pointsf", data_id, dir_data, dir_output, None)
    data_dict = dict(ev.data_setting.default_setting(), tr_batch_size=1000,
                     validation_rough_batch_size=1000, test_rough_batch_size=1000)
    eval_dict = dict(ev.eval_setting.default_setting(), epochs=2, cutoffs=[1, 3, 5, 10],
                     resume=resume)
    sf_para = ev.sf_setting.default_setting(data_dict["num_features"])
    sf_para = dict(sf_para, scorer=dataclasses.replace(sf_para["scorer"], dropout=0.0))
    model_para = {"model_id": "RankMSE", **ev.model_setting.default_para_dict()}
    return ev.kfold_cv_eval(data_dict, eval_dict, sf_para, model_para)


@pytest.mark.parametrize("data_id", ["SyntheticMQ", "MQ2008_Super"])
def test_kfold_cv_eval_matches_jax(data_id, tmp_path, monkeypatch):
    """2 folds x 2 epochs, validation on, the training data resident, from
    the JAX ranker's initial params in each fold (dropout 0): nDCG, nERR, AP
    and P at every cutoff to 1e-5 (scores agree to about 1e-6 relative; no
    two docs' scores come near enough to swap). Each fold keeps its best
    checkpoint, the port's own .pt."""
    dirs = {}
    if data_id != "SyntheticMQ":
        for side in ("port", "jax"):  # each package parses its own copy
            dirs[side] = _letor_dir(tmp_path / f"data_{side}")
    monkeypatch.setattr(tev, "AdhocRanker", _from_jax_ranker(tmp_path))
    got = _kfold(tev.LTREvaluator(device="cpu"), data_id, dirs.get("port"),
                 str(tmp_path / "port"))
    want = _kfold(jev.LTREvaluator(), data_id, dirs.get("jax"), str(tmp_path / "jax"))
    for m in METRICS:
        assert got[m].shape == (4,)
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-5, atol=1e-5, err_msg=m)
    assert 0.0 < got["nDCG"][2] <= 1.0
    folds = [(r, f) for r, _, f in os.walk(tmp_path / "port") if os.path.basename(r)[:5] == "Fold-"]
    assert len(folds) == 2
    for _, files in folds:
        assert len(files) == 1 and files[0].startswith("net_params_epoch_") \
            and files[0].endswith(".pt")


class _Interrupt(Exception):
    pass


def test_interrupted_run_resumes_to_the_same_bits(tmp_path, monkeypatch):
    """A run stopped after fold 1's first epoch and started again with
    resume on gives the uninterrupted run's CV metrics, bit for bit: the
    state (params, optimizer, generator, epoch, validation best) is the
    port's own .pt, and an epoch's batches depend on the epoch alone."""
    full = _kfold(tev.LTREvaluator(device="cpu"), "SyntheticMQ", None, str(tmp_path / "full"),
                  resume=True)
    calls = []
    real = AdhocRanker.train_epoch_resident

    def stop_after_one(self, res, epoch_k, shuffle=True):
        calls.append(epoch_k)
        if len(calls) == 2:
            raise _Interrupt
        return real(self, res, epoch_k, shuffle)

    monkeypatch.setattr(AdhocRanker, "train_epoch_resident", stop_after_one)
    with pytest.raises(_Interrupt):
        _kfold(tev.LTREvaluator(device="cpu"), "SyntheticMQ", None, str(tmp_path / "cut"),
               resume=True)
    monkeypatch.setattr(AdhocRanker, "train_epoch_resident", real)
    states = [r for r, _, f in os.walk(tmp_path / "cut") if tev.TRAIN_STATE in f]
    assert len(states) == 1 and states[0].endswith("Fold-1")
    resumed = _kfold(tev.LTREvaluator(device="cpu"), "SyntheticMQ", None, str(tmp_path / "cut"),
                     resume=True)
    for m in METRICS:
        np.testing.assert_array_equal(resumed[m], full[m])


def test_cli_runs_on_the_cpu_and_writes_its_results(tmp_path):
    """`python -m ptranking_tpu_torch.ltr -device cpu -model RankMSE -data
    SyntheticMQ --debug` (here through its main()): CV metrics and each
    fold's best checkpoint."""
    out = tmp_path / "out"
    perf = ltr.main(["-device", "cpu", "-model", "RankMSE", "-data", "SyntheticMQ", "--debug",
                     "-dir_output", str(out)])
    assert perf["nDCG"].shape == (6,) and np.all(np.isfinite(perf["nDCG"]))
    assert 0.0 < perf["nDCG"][2] <= 1.0
    ckpts = sorted(f for _, _, fs in os.walk(out) for f in fs if f.endswith(".pt"))
    assert len(ckpts) == 2


def _run_dir(root):
    """The run directory under `root` (relative): the parent of the Fold-1
    directories, a player's (G/D) directory taken off."""
    (run,) = {os.path.relpath(r[:-2] if r.endswith((os.sep + "G", os.sep + "D")) else r, root)
              for r, ds, _ in os.walk(root) if "Fold-1" in ds}
    return run


def _files(root):
    """Every file under `root`, relative."""
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root)
                  for f in fs)


def _jax_run_dir(model_id, root, overrides, sf_id="pointsf"):
    """The run directory the JAX package's evaluator of `model_id` names for
    the debug CLI defaults with these overrides (relative to `root`)."""
    if model_id in ("DALETOR", "DivProbRanker"):
        ev = JaxDivLTREvaluator()
        ev.set_settings(True, model_id, "pointsf", "SyntheticDiv", None, str(root), None)
    elif model_id.startswith("IR"):
        ev = JaxAdLTREvaluator(mesh_overrides=overrides)
        ev.set_settings(True, model_id, "pointsf", "SyntheticMQ", None, str(root), None)
    else:
        ev = jev.LTREvaluator(mesh_overrides=overrides)
        ev.set_settings(True, model_id, sf_id, "SyntheticMQ", None, str(root), None)
    data_dict = ev.data_setting.default_setting()
    eval_dict = ev.eval_setting.default_setting()
    if model_id.startswith("IR"):
        eval_dict["epochs"] = 2  # as point_run(epochs=2) sets it
    ev.sf_setting.default_setting(data_dict["num_features"])
    ev.model_setting.default_para_dict()
    return os.path.relpath(ev.setup_output(data_dict, eval_dict), root)


_PLAIN = {}


def _plain_run(model_id, extra, tmp_path_factory):
    """The port's debug CLI run of `model_id` (with the flags `extra`)
    without the multi-device flags (once a module): (CV metrics, run
    directory)."""
    key = (model_id, *extra)
    if key not in _PLAIN:
        out = tmp_path_factory.mktemp(f"plain_{model_id}")
        perf = ltr.main(["-device", "cpu", "--debug", "-model", model_id, *extra,
                         "-dir_output", str(out)])
        _PLAIN[key] = perf, _files(out)
    return _PLAIN[key]


def _metrics(perf):
    return {k: np.asarray(v) for k, v in perf.items() if k != "elapsed_s"}


@pytest.mark.parametrize("argv,item", [
    (["-model", "LightGBMLambdaMART", "-mesh", "data=4"], "item 8"),
    (["-model", "RankMSE", "-shard_docs"], "item 8"),
    (["-model", "DALETOR", "-mesh", "data=2"], "item 8"),
    (["-model", "DivProbRanker", "-shard_docs"], "item 8"),
    (["-model", "IRGAN_Point", "-mesh", "data=2"], "item 8"),
    (["-model", "IRFGAN_List", "-tp"], "item 8"),
    (["-model", "RankMSE", "-mesh", "data=2"], "item 8"),
    (["-model", "RankMSE", "-tp"], "item 8"),
])
def test_cli_refuses_the_branches_and_the_mesh(argv, item, tmp_path, tmp_path_factory):
    """The flags of ROADMAP queue A `item` as the JAX package reads them, in
    a debug run (2 epochs for the adversarial ids):
      * the tree branch ignores the mesh and a companion flag without a mesh
        changes nothing: the run gives the port's plain run's CV metrics
        bit for bit and its files, in the run directory the JAX evaluator
        names (the JAX
        package runs these on one device too; the plain runs are held
        against the JAX package's in this file and the branches' files);
      * `-mesh data=W` runs W data-parallel gloo ranks: finite CV metrics in
        [0, 1] and the run directory the JAX evaluator names for the mesh,
        written once (rank 0), one best checkpoint a fold."""
    model_id = argv[1]
    extra = ["-epochs", "2"] if model_id.startswith("IR") else []
    out = tmp_path / "out"
    perf = ltr.main(["-device", "cpu", "--debug", *argv, *extra, "-dir_output", str(out)])
    got = _metrics(perf)
    mesh = "-mesh" in argv and model_id != "LightGBMLambdaMART"
    if not mesh:
        want, files = _plain_run(model_id, extra, tmp_path_factory)
        for k, v in _metrics(want).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert _files(out) == files
    else:
        assert got and all(np.all(np.isfinite(v)) & np.all((v >= 0) & (v <= 1))
                           for v in got.values())
        best = [f for r, _, fs in os.walk(out) for f in fs if f.startswith("net_params_epoch_")]
        if model_id.startswith("IR"):  # G and D a fold; the stop guard may end a fold early
            assert 0 < len(best) <= 4
        else:
            assert len(best) == 2
    if model_id != "LightGBMLambdaMART":
        ov = ltr.parse_mesh_overrides(ltr.build_parser().parse_args(argv))
        assert _run_dir(out) == _jax_run_dir(model_id, tmp_path / "jax", ov)


@pytest.mark.parametrize("argv,item", [
    (["-model", "RankMSE", "-mesh", "data=1,model=2", "-tp"], "item 8b"),
    (["-model", "RankMSE", "-sf_id", "listsf", "-mesh", "model=2", "-pp_stages", "2"],
     "item 8b"),
    (["-model", "RankMSE", "-mesh", "data=1,model=2"], "item 8b"),
    (["-model", "RankMSE", "-mesh", "data=1,seq=2", "-shard_docs"], "item 8c"),
    (["-model", "DALETOR", "-mesh", "data=1,seq=2"], "item 8c"),
    (["-model", "IRGAN_Point", "-mesh", "model=2"], "item 8b"),
])
def test_cli_refuses_the_slices_still_to_come(argv, item, tmp_path, tmp_path_factory):
    """The flags of item 8b and 8c run on 2 gloo ranks: a `model` axis, with
    the pointsf's weights split (-tp), the listsf's encoder staged at
    inference (-pp_stages 2), or the params whole (no flag, and the
    adversarial branch); a `seq` axis, with each list's docs split
    (-shard_docs), or, on the diversification branch, the rows repeated on
    both ranks. With `data` = 1 every rank takes the whole batch and draws
    the one-device dropout masks (full widths under -tp, whole lists under
    -shard_docs), so the CV metrics are the one-device run's within 1e-5,
    and the run directory is the one the JAX evaluator names."""
    model_id = argv[1]
    extra = ["-epochs", "2"] if model_id.startswith("IR") else []
    sf_id = argv[argv.index("-sf_id") + 1] if "-sf_id" in argv else "pointsf"
    extra += ["-sf_id", sf_id] if "-sf_id" in argv else []
    out = tmp_path / "out"
    got = ltr.main(["-device", "cpu", "--debug", *argv, *extra, "-dir_output", str(out)])
    want, _ = _plain_run(model_id, extra, tmp_path_factory)
    for k, v in _metrics(want).items():
        np.testing.assert_allclose(_metrics(got)[k], v, atol=1e-5, err_msg=k)
    ov = ltr.parse_mesh_overrides(ltr.build_parser().parse_args(argv))
    want_dir = _jax_run_dir(model_id, tmp_path / "jax", ov, sf_id)
    assert _run_dir(out) == want_dir


def test_evaluator_refuses_parallel_eval_settings():
    """Without a mesh the companion settings change nothing (an AdhocRanker
    with the given scan_steps); a mesh needs the process group of its ranks;
    under a mesh `tp`, `pp_stages` (item 8b), `shard_docs` and `cp_impl`
    (item 8c) reach the DistributedTrainer (in a one-rank group: a mesh of
    one rank), which holds JAX's guards: a pipeline of 2 stages needs a
    `model` axis of 2, and `cp_impl` is ring or ulysses."""
    from ptranking_tpu_torch.parallel.launch import one_rank_group
    from ptranking_tpu_torch.parallel.train import DistributedTrainer

    ev = tev.LTREvaluator(device="cpu")
    sf = SFSetting().default_setting(46)
    r = ev.load_ranker(sf, {"model_id": "RankMSE"}, LabelType.MultiLabel,
                       {"tp": True, "shard_docs": True, "cp_impl": "ulysses", "pp_stages": 2,
                        "eval_chunk": 8, "scan_steps": 4})
    assert type(r) is AdhocRanker and r.scan_steps == 4
    with pytest.raises(RuntimeError, match="process group"):
        ev.load_ranker(sf, {"model_id": "RankMSE"}, None, {"mesh": {"data": 2},
                                                           "shard_docs": True})
    listsf = SFSetting(sf_id="listsf").default_setting(46)
    with one_rank_group("cpu"):
        tr = ev.load_ranker(sf, {"model_id": "RankMSE"}, None,
                            {"mesh": {"data": 1}, "tp": True, "scan_steps": 4})
        assert type(tr) is DistributedTrainer and tr.tp and tr.scan_steps == 4
        tr = ev.load_ranker(listsf, {"model_id": "RankMSE"}, None,
                            {"mesh": {"data": 1}, "pp_stages": 1})
        assert type(tr) is DistributedTrainer and tr.pp_stages == 1
        tr = ev.load_ranker(listsf, {"model_id": "LambdaRank"}, None,
                            {"mesh": {"data": 1, "seq": 1}, "shard_docs": True,
                             "cp_impl": "ulysses"})
        assert type(tr) is DistributedTrainer and tr.shard_docs and tr.cp_impl == "ulysses"
        with pytest.raises(ValueError, match="cp_impl"):
            ev.load_ranker(listsf, {"model_id": "LambdaRank"}, None,
                           {"mesh": {"data": 1}, "shard_docs": True, "cp_impl": "zigzag"})
        with pytest.raises(ValueError, match="model axis"):
            ev.load_ranker(listsf, {"model_id": "RankMSE"}, None,
                           {"mesh": {"data": 1}, "pp_stages": 2})


def test_python_m_entry_point_runs(tmp_path):
    """The module runs as `python -m ptranking_tpu_torch.ltr`, and with
    `-mesh data=2` (no launcher) it starts its two gloo ranks itself: the
    run's CV line (printed once, by rank 0), in the run directory the JAX
    evaluator names."""
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-m", "ptranking_tpu_torch.ltr", "-device", "cpu",
                           "-model", "IRGAN_Point", "-mesh", "data=2", "--debug", "-epochs", "2",
                           "-dir_output", str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("IRGAN_Point 2-fold CV") == 1
    assert _run_dir(out) == _jax_run_dir("IRGAN_Point", tmp_path / "jax",
                                         {"mesh": {"data": 2}})
