"""The port's DivLTREvaluator and CLI against the JAX package's: a 2-fold x
2-epoch k-fold run (and one in rerank mode) whose folds start from the JAX
ranker's initial params, the TREC Web Track folds and the TREC artifacts
(topic map, qrels, run), and `python -m ptranking_tpu_torch.ltr -model
DALETOR | DivProbRanker -data SyntheticDiv -debug` on the CPU with an exact
-reproduce."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ptranking_tpu.diversification import DivLTREvaluator as JaxDivEvaluator
from ptranking_tpu.diversification import evaluator as jev
from ptranking_tpu.diversification import DivRanker as JaxDivRanker
from ptranking_tpu.diversification import DivScorerConfig as JaxDivScorerConfig
from ptranking_tpu.diversification import make_synthetic_div_queries as jax_make_queries
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.diversification import DivRanker, make_synthetic_div_queries
from ptranking_tpu_torch.diversification import evaluator as tev
from ptranking_tpu_torch.utils.native_build import find_cxx

torch.set_num_threads(1)

METRICS = ("aNDCG", "ERR-IA", "nERR-IA")


# ------------------------------------------------------------ k-fold runs


def _from_jax_ranker(tmp_path):
    """The port's DivRanker whose init() loads the JAX ranker's params and
    optimizer state of the same seed (through its .pkl)."""

    class FromJax(DivRanker):
        def init(self):
            jr = JaxDivRanker(self.model_id,
                              JaxDivScorerConfig(**dataclasses.asdict(self.scorer_cfg)),
                              model_paras=self.model_paras,
                              opt_cfg=JaxOptimizerConfig(**dataclasses.asdict(self.opt_cfg)),
                              seed=self.seed).init()
            path = str(tmp_path / f"init_{self.seed}.pkl")
            jr.save(path)
            return self.load(path)

    return FromJax


def _small_folds(make):
    """A load_fold of 12 queries of 5..15 docs a split (one 16-doc bucket, so
    the JAX package compiles one shape), from each package's own generator."""

    def load_fold(self, data_dict, fold_k):
        return tuple(make(num_queries=12, min_docs=5, max_docs=15, seed=seed + fold_k)
                     for seed in (0, 1000, 2000))

    return load_fold


def _kfold(ev, model_id, dir_output, rerank=False):
    """The debug SyntheticDiv settings (2 folds, D = 100, the default pointsf
    at dropout 0) on `_small_folds`, 2 epochs, validation on; with rerank,
    a first-stage ranker (initialised, seed 1 + fold) keeps each query's
    top 8 docs."""
    ev.set_settings(True, model_id, "pointsf", "SyntheticDiv", None, dir_output, None)
    data_dict = ev.data_setting.default_setting()
    eval_dict = dict(ev.eval_setting.default_setting(), epochs=2)
    if rerank:
        eval_dict.update(rerank=True, rerank_k=8)
    sf_para = ev.sf_setting.default_setting(data_dict["num_features"])
    sf_para = dict(sf_para, scorer=dataclasses.replace(sf_para["scorer"], dropout=0.0))
    mp = {"model_id": model_id, **ev.model_setting.default_para_dict()}
    return ev.div_cv_eval(data_dict, eval_dict, sf_para, mp, write_run_files=True)


@pytest.mark.parametrize("rerank", [False, True])
def test_kfold_div_cv_eval_matches_jax(rerank, tmp_path, monkeypatch):
    """DivProbRanker (SuperSoft-aNDCG), 2 folds x 2 epochs, the data resident,
    from the JAX ranker's initial params in each fold (the first stage's
    too): aNDCG, ERR-IA and nERR-IA at every cutoff to 1e-5; each fold keeps
    one best checkpoint, the port's .pt, and writes its run and qrels."""
    monkeypatch.setattr(tev, "DivRanker", _from_jax_ranker(tmp_path))
    monkeypatch.setattr(tev.DivLTREvaluator, "load_fold",
                        _small_folds(make_synthetic_div_queries))
    monkeypatch.setattr(JaxDivEvaluator, "load_fold", _small_folds(jax_make_queries))
    got = _kfold(tev.DivLTREvaluator(device="cpu"), "DivProbRanker", str(tmp_path / "port"),
                 rerank)
    want = _kfold(JaxDivEvaluator(), "DivProbRanker", str(tmp_path / "jax"), rerank)
    for m in METRICS:
        assert got[m].shape == (5,)
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-5, atol=1e-5, err_msg=m)
    assert 0.0 < got["aNDCG"][2] <= 1.0
    files = [f for _, _, fs in os.walk(tmp_path / "port") for f in fs]
    assert sum(f.startswith("net_params_epoch_") and f.endswith(".pt") for f in files) == 2
    assert sum(f.endswith("_run.txt") for f in files) == 2


@pytest.mark.parametrize("model_id", ["DALETOR", "DivProbRanker"])
def test_cli_runs_and_reproduces_on_the_cpu(model_id, tmp_path):
    """`python -m ptranking_tpu_torch.ltr -device cpu -model <id> -data
    SyntheticDiv -debug` (its main): finite CV metrics, a run file a fold;
    -reproduce from the saved checkpoints gives the same CV metrics, bit for
    bit, and the ndeval columns where a C++ compiler exists."""
    argv = ["-device", "cpu", "-model", model_id, "-data", "SyntheticDiv", "-debug",
            "-epochs", "2", "-dir_output", str(tmp_path)]
    perf = ltr.main(argv)
    for m in METRICS:
        assert perf[m].shape == (5,) and np.all(np.isfinite(perf[m]))
    runs = [f for _, _, fs in os.walk(tmp_path) for f in fs if f.endswith("_run.txt")]
    assert sorted(runs) == ["fold_1_run.txt", "fold_2_run.txt"]
    again = ltr.main(argv + ["-reproduce"])
    for m in METRICS:
        np.testing.assert_array_equal(again[m], perf[m])
        if find_cxx() is not None:
            assert np.all(np.isfinite(again[f"{m}(ndeval)"]))


def _trec_layout(root, n_queries=9, D=6):
    """The TREC Web Track raw layout (representations, permutations, query
    docs) and two folds' folder{k}/config.yml (one in YAML, one in JSON)."""
    rng = np.random.RandomState(2)
    q_reprs, d_reprs, perms, q_docs = {}, {}, {}, {}
    for qi in range(n_queries):
        qid = str(51 + qi)
        docs = [f"clueweb09-en{qi:04d}-{j:02d}" for j in range(rng.randint(4, 9))]
        q_reprs[qid] = rng.randn(D).tolist()
        for d in docs:
            d_reprs[d] = rng.randn(D).tolist()
        perms[qid] = {"permutation": docs}
        q_docs[qid] = {d: [str(s) for s in range(1, 5) if rng.rand() < 0.4] for d in docs}
    for name, obj in (("query_representation.dat", q_reprs), ("doc_representation.dat", d_reprs),
                      ("query_permutation.json", perms), ("query_doc.json", q_docs)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)
    qids = sorted(q_reprs)
    for k, text in ((1, "train:\n" + "".join(f"  - {q}\n" for q in qids[:5])
                     + f"vali: [{qids[5]}, {qids[6]}]\ntest:\n  - {qids[7]}\n  - {qids[8]}\n"),
                    (2, json.dumps({"train": qids[4:], "vali": qids[:2], "test": qids[2:4]}))):
        os.makedirs(os.path.join(root, f"folder{k}"))
        with open(os.path.join(root, f"folder{k}", "config.yml"), "w") as f:
            f.write(text)
    return str(root)


@pytest.mark.parametrize("add_noise", [False, True])
def test_trec_folds_and_artifacts_equal_jax(add_noise, tmp_path):
    """load_fold on the TREC Web Track layout (noise on or off), the topic
    map and the qrels and run writers give the JAX package's queries and
    bytes."""
    root = _trec_layout(tmp_path)
    data_dict = {"data_id": "WT_Div_0912_Implicit", "dir_data": root, "add_noise": add_noise,
                 "std_delta": 0.5}
    for k in (1, 2):
        got = tev.DivLTREvaluator(device="cpu").load_fold(data_dict, k)
        want = JaxDivEvaluator().load_fold(data_dict, k)
        for gs, ws in zip(got, want):
            assert [q.qid for q in gs] == [q.qid for q in ws] and gs
            for a, b in zip(gs, ws):
                assert a.docnos == b.docnos
                for x, y in zip(a[1:4], b[1:4]):
                    np.testing.assert_array_equal(x, y)
    test_qs = got[2]
    assert tev.build_topic_map(test_qs) == jev.build_topic_map(test_qs)
    for mod, name in ((tev, "port"), (jev, "jax")):
        mod.write_div_qrels(str(tmp_path / f"{name}_qrels.txt"), test_qs)
        for q in test_qs:
            mod.write_trec_run(str(tmp_path / f"{name}_run.txt"), q.qid, list(q.docnos),
                               list(np.linspace(1.0, 0.0, len(q.docnos))))
    for suffix in ("qrels", "run"):
        with open(tmp_path / f"port_{suffix}.txt") as f, open(tmp_path / f"jax_{suffix}.txt") as g:
            assert f.read() == g.read()
