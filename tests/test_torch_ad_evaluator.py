"""The port's adversarial experiment surface against the JAX package's: the
settings (every grid point's dicts, para strings and run directory, for all
six ids, from the built-in grids and from a JSON with 'd_g_epoch' and other
axes), a 2-fold debug `ltr.main` run of IRGAN_Point on the CPU (finite G
and D CV nDCG, the players' validation tapes, the run directory JAX's
evaluator names), a `-dir_json` grid run of IRFGAN_List, and the refusals:
CUDA where there is none, and the multi-device flags: `-mesh data=2` runs
both players data-parallel over two gloo ranks, `-tp` and `-shard_docs`
without a mesh change nothing (as in the JAX package), and a mesh's
`seq` axis (ROADMAP queue A item 8c) runs the one-device results."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ptranking_tpu.adversarial import AdLTREvaluator as JaxAdLTREvaluator
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.adversarial import (AD_MACHINES, LTR_ADVERSARIAL_MODELS,
                                             AdLTREvaluator, AdSFSetting)
from ptranking_tpu_torch.parallel import launch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _short_rank_timeouts(monkeypatch):
    """The ranks that `ltr.main -mesh data=2` starts wait at most 120 s in
    a collective and 300 s in all: a deadlock fails its test in minutes."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launch, "DEFAULT_JOIN_TIMEOUT_S", 300.0)


def _asdict(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _settings_walk(ev, tmp, model_id, dir_json):
    """Every grid point of an evaluator's settings as plain dicts, with the
    model's para string and the run directory each gives (relative to
    `tmp`), then the defaults' (point_run's)."""
    ev.set_settings(True, model_id, "pointsf", "SyntheticMQ", None, str(tmp), dir_json)
    out = []
    for data_dict in ev.data_setting.grid_search():
        for eval_dict in ev.eval_setting.grid_search():
            for sf_para in ev.sf_setting.grid_search(data_dict["num_features"]):
                for ad_para in ev.model_setting.grid_search():
                    run = ev.setup_output(data_dict, dict(eval_dict, dir_output=str(tmp)))
                    out.append(({k: str(v) for k, v in data_dict.items()},
                                {k: v for k, v in eval_dict.items() if k != "dir_output"},
                                {k: _asdict(v) for k, v in sf_para.items()}, dict(ad_para),
                                ev.model_setting.to_para_string(log=True),
                                os.path.relpath(run, tmp)))
    ev.set_settings(True, model_id, "pointsf", "SyntheticMQ", None, str(tmp), dir_json)
    data_dict = ev.data_setting.default_setting()
    eval_dict = ev.eval_setting.default_setting()
    sf = ev.sf_setting.default_setting(data_dict["num_features"])
    paras = ev.model_setting.default_para_dict()
    run = ev.setup_output(data_dict, dict(eval_dict, dir_output=str(tmp)))
    out.append(({k: str(v) for k, v in data_dict.items()},
                {k: v for k, v in eval_dict.items() if k != "dir_output"},
                {k: _asdict(v) for k, v in sf.items()}, dict(paras),
                ev.model_setting.to_para_string(), os.path.relpath(run, tmp)))
    return out


def _ad_json(tmp_path, model_id) -> str:
    """A JSON config dir: Ad_Data_Eval_ScoringFunction.json with grid axes
    and <model_id>Parameter.json with 'd_g_epoch' and the model's own axes."""
    d = tmp_path / "json"
    d.mkdir()
    (d / "Ad_Data_Eval_ScoringFunction.json").write_text(json.dumps({
        "AdDataSetting": {"data_id": "SyntheticMQ", "dir_data": str(tmp_path),
                          "min_docs": [10], "tr_batch_size": [256, 512]},
        "AdEvalSetting": {"dir_output": str(tmp_path / "out"), "epochs": [3],
                          "do_validation": True, "vali_k": [5]},
        "SFParameter": {"sf_id": "pointsf", "opt": ["Adam"], "lr": [1e-3, 1e-2],
                        "pointsf": {"layers": [2, 5], "AF": ["R"]}}}))
    axes = {"d_g_epoch": ["1-1", "2-3"], "samples_per_query": [5, 10]}
    if model_id.startswith("IRFGAN"):
        axes["f_div_id"] = ["KL", "JS"]
    if model_id == "IRGAN_List":
        axes.update(PL_D=[True, False], dropLog=[True, False], repTrick_G=[False, True])
    (d / f"{model_id}Parameter.json").write_text(json.dumps({model_id: axes}))
    return str(d)


@pytest.mark.parametrize("use_json", [False, True])
@pytest.mark.parametrize("model_id", LTR_ADVERSARIAL_MODELS)
def test_settings_and_run_names_equal_jax(model_id, use_json, tmp_path):
    dir_json = _ad_json(tmp_path, model_id) if use_json else None
    got = _settings_walk(AdLTREvaluator(device="cpu"), tmp_path, model_id, dir_json)
    want = _settings_walk(JaxAdLTREvaluator(), tmp_path, model_id, dir_json)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g == w


def _players_best(root):
    """{(player, fold dir): its best checkpoints} under a run directory."""
    return {tuple(os.path.relpath(r, root).split(os.sep)): sorted(fs)
            for r, _, fs in os.walk(root) if os.path.basename(r).startswith("Fold-")}


def test_cli_point_run_on_the_cpu(tmp_path):
    """`ltr.main` of IRGAN_Point, debug (2 folds), 2 epochs: finite G and D
    CV nDCG at every cutoff, in the run directory the JAX evaluator names for
    the same settings, with a validation tape a player and fold holding at
    most one best checkpoint. (The pointsf's ReLU top layer can leave a
    fresh G scoring 0 everywhere; the stop guard then ends that fold before
    its first validation, as in the JAX package.)"""
    out = tmp_path / "out"
    cv = ltr.main(["-device", "cpu", "-model", "IRGAN_Point", "-data", "SyntheticMQ", "-debug",
                   "-epochs", "2", "-dir_output", str(out)])
    assert set(cv) == {"G", "D"}
    for name in ("G", "D"):
        assert cv[name].shape == (6,) and np.all(np.isfinite(cv[name]))
        assert np.all((cv[name] >= 0.0) & (cv[name] <= 1.0))
    jev = JaxAdLTREvaluator()
    jev.set_settings(True, "IRGAN_Point", "pointsf", "SyntheticMQ", None, str(tmp_path / "j"),
                     None)
    data_dict = jev.data_setting.default_setting()
    eval_dict = jev.eval_setting.default_setting()
    eval_dict["epochs"] = 2  # as point_run(epochs=2) sets it
    jev.sf_setting.default_setting(data_dict["num_features"])
    jev.model_setting.default_para_dict()
    run = os.path.relpath(jev.setup_output(data_dict, eval_dict), tmp_path / "j")
    assert run.startswith("IRGAN_Point_SF_R5R_Adam_Lr0.001_SyntheticMQ_")
    assert [os.path.relpath(r, out) for r, ds, _ in os.walk(out) if "G" in ds] == [run]
    best = _players_best(out / run)
    assert sorted(best) == [(p, f"Fold-{k}") for p in ("D", "G") for k in (1, 2)]
    assert all(len(v) <= 1 for v in best.values()) and any(best.values())


def test_cli_json_grid_run_on_the_cpu(tmp_path):
    """`ltr.main -dir_json` of IRFGAN_List (a grid run, debug: 2 folds of 5
    epochs) with a sigmoid top layer, which never scores 0 everywhere: both
    players' best checkpoint in every fold, under JAX's grid directory."""
    d = tmp_path / "json"
    d.mkdir()
    out = tmp_path / "out"
    (d / "Ad_Data_Eval_ScoringFunction.json").write_text(json.dumps({
        "AdDataSetting": {"data_id": "SyntheticMQ", "dir_data": str(tmp_path)},
        "AdEvalSetting": {"dir_output": str(out), "epochs": [2]},
        "SFParameter": {"sf_id": "pointsf", "pointsf": {
            "layers": [2], "AF": ["R"], "TL_AF": ["S"], "BN": [False]}}}))
    cv = ltr.main(["-device", "cpu", "-model", "IRFGAN_List", "-dir_json", str(d), "-debug"])
    assert all(np.all(np.isfinite(cv[n])) for n in ("G", "D"))
    (grid,) = os.listdir(out)
    assert grid == "gpu_grid_IRFGAN_List"
    (prefix,) = os.listdir(out / grid)
    (paras,) = os.listdir(out / grid / prefix)
    assert paras == "KL_1_1_DG_S5_top5"
    best = _players_best(out / grid / prefix / paras)
    assert sorted(best) == [(p, f"Fold-{k}") for p in ("D", "G") for k in (1, 2)]
    assert all(len(v) == 1 for v in best.values()), best


_PLAIN = {}


@pytest.mark.parametrize("argv", [["-mesh", "data=2"], ["-tp"], ["-shard_docs"]])
def test_cli_refuses_the_multi_device_flags(argv, tmp_path, tmp_path_factory):
    """The multi-device flags on IRGAN_Point's debug CLI run (2 epochs), as
    the JAX package reads them: `-tp` and `-shard_docs` change nothing (the
    plain run's CV metrics bit for bit, and its files); `-mesh data=2` runs
    both players over two gloo ranks (finite G and D CV nDCG in [0, 1]), in
    the run directory the JAX evaluator names."""
    run = ["-device", "cpu", "-model", "IRGAN_Point", "-data", "SyntheticMQ", "-debug",
           "-epochs", "2"]
    out = tmp_path / "out"
    cv = ltr.main([*run, "-dir_output", str(out), *argv])
    files = sorted(os.path.relpath(os.path.join(r, f), out)
                   for r, _, fs in os.walk(out) for f in fs)
    if argv[0] == "-mesh":
        for name in ("G", "D"):
            assert cv[name].shape == (6,) and np.all((cv[name] >= 0.0) & (cv[name] <= 1.0))
        jev = JaxAdLTREvaluator(mesh_overrides={"mesh": {"data": 2}})
        jev.set_settings(True, "IRGAN_Point", "pointsf", "SyntheticMQ", None,
                         str(tmp_path / "j"), None)
        data_dict = jev.data_setting.default_setting()
        eval_dict = jev.eval_setting.default_setting()
        eval_dict["epochs"] = 2
        jev.sf_setting.default_setting(data_dict["num_features"])
        jev.model_setting.default_para_dict()
        want = os.path.relpath(jev.setup_output(data_dict, eval_dict), tmp_path / "j")
        assert {f.split(os.sep + "G" + os.sep)[0] for f in files if os.sep + "G" + os.sep in f} \
            == {want}
        return
    want_cv, want_files = _plain_cli(run, tmp_path_factory)
    for name in ("G", "D"):
        np.testing.assert_array_equal(cv[name], want_cv[name])
    assert files == want_files


def _plain_cli(run, tmp_path_factory):
    """(CV results, files) of the CLI run `run` on one device, once a module."""
    if "plain" not in _PLAIN:
        plain_out = tmp_path_factory.mktemp("plain")
        _PLAIN["plain"] = (ltr.main([*run, "-dir_output", str(plain_out)]),
                           sorted(os.path.relpath(os.path.join(r, f), plain_out)
                                  for r, _, fs in os.walk(plain_out) for f in fs))
    return _PLAIN["plain"]


def test_evaluator_and_machines_refuse_a_mesh(tmp_path, tmp_path_factory):
    """A mesh's `seq` axis (ROADMAP queue A item 8c) runs the branch on 2
    gloo ranks that repeat each other's rows, as the JAX package ignores
    shard_docs here: IRGAN_Point's debug CLI run (2 epochs) on `-mesh
    data=1,seq=2` gives the one-device run's G and D CV nDCG within 1e-5. A
    data or model axis without the process group of its ranks raises
    (`ltr.main` or torchrun make the group; a `model` axis runs there, the
    players whole on every model rank)."""
    run = ["-device", "cpu", "-model", "IRGAN_Point", "-data", "SyntheticMQ", "-debug",
           "-epochs", "2"]
    cv = ltr.main([*run, "-dir_output", str(tmp_path / "seq"), "-mesh", "data=1,seq=2"])
    want_cv, _ = _plain_cli(run, tmp_path_factory)
    for name in ("G", "D"):
        np.testing.assert_allclose(cv[name], want_cv[name], atol=1e-5, err_msg=name)
    for mesh in ({"data": 2}, {"data": 1, "model": 2}):
        ev = AdLTREvaluator(device="cpu", mesh_overrides={"mesh": mesh})
        with pytest.raises(RuntimeError, match="process group"):
            ev.point_run(debug=True, model_id="IRFGAN_List", data_id="SyntheticMQ",
                         dir_output=str(tmp_path), epochs=1)


@pytest.mark.parametrize("entry", ["machine", "evaluator", "ltr_main"])
def test_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sf = AdSFSetting().default_setting(4)
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        if entry == "machine":
            AD_MACHINES["IRGAN_Point"](sf_para=sf, ad_para_dict={})
        elif entry == "evaluator":
            AdLTREvaluator()
        else:
            ltr.main(["-model", "IRFGAN_Pair", "-dir_output", str(tmp_path)])
