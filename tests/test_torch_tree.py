"""The port's tree branch (tree/{objectives,gbdt,lambdamart,settings,evaluator}.py
and the tree ids of `python -m ptranking_tpu_torch.ltr`) against the JAX
package's (ptranking_tpu/tree/)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu import ltr as jax_ltr
from ptranking_tpu.tree import jax_gbdt as J
from ptranking_tpu.tree import objectives as jax_obj
from ptranking_tpu.tree import settings as jax_settings
from ptranking_tpu.tree.evaluator import cal_metric_at_ks as jax_cal_metric
from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.tree import evaluator as tev
from ptranking_tpu_torch.tree import gbdt as T
from ptranking_tpu_torch.tree import lambdamart, objectives, settings

torch.set_num_threads(1)


def _rank_data(nq, n=16, F=6, seed=0):
    """The JAX package's test data: graded labels from a linear teacher."""
    rng = np.random.RandomState(seed)
    w = np.linspace(1.0, 2.0, F)
    data, target, group = [], [], []
    for _ in range(nq):
        X = rng.randn(n, F)
        s = X @ w + 0.3 * rng.randn(n)
        data.append(X)
        target.append(np.digitize(s, np.quantile(s, [0.5, 0.75, 0.9])))
        group.append(n)
    return np.concatenate(data), np.concatenate(target).astype(float), np.asarray(group)


# --- objectives -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(objectives.CUSTOM_OBJECTIVES))
def test_objectives_bit_for_bit(name):
    """grad and hess of every objective equal the JAX package's, bit for bit,
    on ragged groups with ties."""
    rng = np.random.RandomState(1)
    group = np.array([1, 7, 30, 12])
    labels = rng.randint(0, 5, group.sum()).astype(float)
    preds = np.round(rng.randn(group.sum()), 1)  # ties among the predictions
    got = objectives.CUSTOM_OBJECTIVES[name][0](labels, preds, group)
    want = jax_obj.CUSTOM_OBJECTIVES[name][0](labels, preds, group)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pair_type", objectives.PAIR_TYPES)
@pytest.mark.parametrize("weighting_type", objectives.WEIGHTING_TYPE)
def test_per_query_lambda_bit_for_bit(pair_type, weighting_type):
    rng = np.random.RandomState(2)
    labels = rng.randint(0, 3, 25).astype(float)
    preds = rng.randn(25)
    kw = dict(pair_type=pair_type, weighting=True, weighting_type=weighting_type,
              symmetric_hessian=pair_type == "All")
    for a, b in zip(objectives.per_query_grad_hess_lambda(preds, labels, **kw),
                    jax_obj.per_query_grad_hess_lambda(preds, labels, **kw)):
        np.testing.assert_array_equal(a, b)


# --- binning, growing, predicting -------------------------------------------------


@pytest.mark.parametrize("num_bins", [4, 16, 64])
def test_binning_equals_jax(num_bins):
    rng = np.random.RandomState(num_bins)
    data = rng.randn(500, 7)
    data[:, 2] = rng.randint(0, 3, 500)  # few distinct values: +inf-padded edges
    edges = T.quantile_bin_edges(data, num_bins)
    want = J.quantile_bin_edges(data, num_bins)
    np.testing.assert_array_equal(edges, want)
    np.testing.assert_array_equal(T.bin_features(data, edges), J.bin_features(data, want))


def _grow_both(bins, grad, hess, depth, num_bins, l2, mch, feat_mask=None):
    want = J.grow_tree(jnp.asarray(bins), jnp.asarray(grad, jnp.float32),
                       jnp.asarray(hess, jnp.float32), depth=depth, num_bins=num_bins, l2=l2,
                       min_child_hessian=mch,
                       feat_mask=None if feat_mask is None else jnp.asarray(feat_mask))
    got = T.grow_tree(torch.from_numpy(bins), torch.tensor(grad, dtype=torch.float32),
                      torch.tensor(hess, dtype=torch.float32), depth, num_bins, l2, mch,
                      None if feat_mask is None else torch.from_numpy(feat_mask))
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("n,F,num_bins,depth,l2,masked", [
    (2000, 13, 16, 4, 0.0, False), (2000, 13, 16, 4, 1.0, True), (700, 8, 64, 3, 0.5, False),
    (300, 3, 8, 5, 0.0, True)])
def test_grow_tree_dyadic_equals_jax(n, F, num_bins, depth, l2, masked):
    """On dyadic grad and hess (their sums are exact in any order, in fp32
    and in the port's fixed point) the port's tree equals JAX's exactly:
    splits, bins and leaves (NaN leaves of empty nodes included, bit for
    bit). F = 13 and 3 take the padded feature block."""
    rng = np.random.RandomState(n + F)
    bins = rng.randint(0, num_bins, (n, F)).astype(np.int32)
    grad = rng.randint(-64, 65, n) / 64.0
    hess = rng.randint(1, 65, n) / 128.0
    feat_mask = (rng.rand(F) > 0.4) if masked else None
    got, want = _grow_both(bins, grad, hess, depth, num_bins, l2, 1e-3, feat_mask)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_grow_tree_real_grads_near_jax():
    """On real lambda gradients the histograms are the exact sums (JAX's fp32
    sums within 1e-5 relative of them), the splits equal JAX's and the
    leaves agree within 1e-5 relative."""
    rng = np.random.RandomState(3)
    n, F, nb = 3000, 10, 32
    bins = rng.randint(0, nb, (n, F)).astype(np.int32)
    group = np.full(100, 30)
    labels = rng.randint(0, 3, n).astype(float)
    grad, hess = objectives.CUSTOM_OBJECTIVES["lambdarank_newton"][0](
        labels, 0.1 * rng.randn(n), group)
    # level 0: every doc in node 0
    g32, h32 = grad.astype(np.float32), hess.astype(np.float32)
    gh = torch.stack([torch.from_numpy(g32), torch.from_numpy(h32)], -1)
    scales = [T.fixed_point_scale(gh[:, c], n) for c in range(2)]
    src = torch.stack([T.to_fixed(gh[:, c], scales[c]) for c in range(2)], -1).repeat(5, 1)
    hist = T.level_histograms(torch.from_numpy(bins).t().reshape(2, 5, n),
                              torch.zeros(n, dtype=torch.int64), src, 1, nb)
    exact = np.zeros((F, nb, 2))
    for f in range(F):
        np.add.at(exact[f], bins[:, f], np.stack([g32, h32], -1).astype(np.float64))
    for c in range(2):
        got = T.from_fixed(hist[0, ..., c], scales[c]).numpy()
        np.testing.assert_allclose(got, exact[..., c], rtol=1e-5, atol=1e-5 * np.abs(
            exact[..., c]).max())
    got, want = _grow_both(bins, grad, hess, 4, nb, 0.0, 1e-3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    real = np.isfinite(want[2])
    np.testing.assert_allclose(got[2][real], want[2][real], rtol=1e-5)


def test_fixed_point_scale_bounds_the_sums():
    """n values under the scale sum below 2**62: the largest possible sum of
    the largest magnitude does not overflow int64."""
    for vmax, n in ((1.0, 2_258_514), (3.7e5, 10), (1e-30, 1000), (0.0, 5)):
        v = torch.full((n,), vmax, dtype=torch.float32)
        s = T.fixed_point_scale(v, n)
        total = T.to_fixed(v[:1], s).item() * n
        assert total < 2 ** 62
        if vmax:
            assert T.from_fixed(torch.tensor([T.to_fixed(v[:1], s).item()]), s).item() == \
                np.float32(vmax)


def test_predict_forest_of_a_jax_forest():
    """A forest the JAX package fitted, carried over by gbdt_from_jax,
    predicts JAX's scores within 1e-6; save and load keep it."""
    tr, te = _rank_data(30, seed=0), _rank_data(10, seed=2)
    jm = J.TPUGBDTRanker(J.GBDTConfig(num_trees=6, max_depth=3, num_bins=16,
                                      learning_rate=0.3)).fit(*tr)
    cfg = {f: getattr(jm.cfg, f) for f in vars(jm.cfg)}
    tm = T.gbdt_from_jax(jm.edges, jm.trees, cfg, device="cpu")
    want = jm.predict(te[0])
    np.testing.assert_allclose(tm.predict(te[0]), want, rtol=0, atol=1e-6)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tm.save(os.path.join(d, "f.model"))
        again = T.GBDTRanker.load(os.path.join(d, "f.model"), device="cpu")
    np.testing.assert_array_equal(again.predict(te[0]), tm.predict(te[0]))


def test_small_fit_against_jax():
    """A depth-3 fit of 5 trees with validation: the first tree's splits
    equal JAX's, predictions within 1e-4, and the test nDCG@5 within 0.02
    (the sums round apart by an ulp, which can move a near-tie split later
    on)."""
    tr, va, te = _rank_data(60, seed=0), _rank_data(15, seed=1), _rank_data(15, seed=2)
    kw = dict(num_trees=5, max_depth=3, num_bins=16, learning_rate=0.2)
    jm = J.TPUGBDTRanker(J.GBDTConfig(**kw)).fit(*tr, vali=va)
    tm = T.GBDTRanker(T.GBDTConfig(**kw), device="cpu").fit(*tr, vali=va)
    assert len(tm.trees) == len(jm.trees) and tm.best_round == jm.best_round
    np.testing.assert_array_equal(tm.trees[0][0], jm.trees[0][0])
    np.testing.assert_array_equal(tm.trees[0][1], jm.trees[0][1])
    pt, pj = tm.predict(te[0]), jm.predict(te[0])
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    nt, nj = T._ndcg_at_k(pt, te[1], te[2], 5), J._ndcg_at_k(pj, te[1], te[2], 5)
    rand = T._ndcg_at_k(np.random.RandomState(9).randn(len(te[1])), te[1], te[2], 5)
    assert abs(nt - nj) <= 0.02 and nt > rand + 0.2


def test_feature_fraction_restricts_splits():
    """With feat_mask, real splits use only allowed features (the no-op
    split, bin num_bins - 1, carries feature 0 and does not count)."""
    rng = np.random.RandomState(5)
    n, F, B = 256, 8, 16
    bins = rng.randint(0, B, size=(n, F)).astype(np.int32)
    allowed = np.zeros(F, bool)
    allowed[[1, 4, 6]] = True
    sf, sb, _ = T.grow_tree(torch.from_numpy(bins), torch.from_numpy(rng.randn(n).astype(
        np.float32)), torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32) + 0.1), 3, B, 1.0,
        0.0, torch.from_numpy(allowed))
    real = sb.numpy() != B - 1
    assert real.any() and set(sf.numpy()[real]) <= {1, 4, 6}


def test_bagging_and_feature_fraction_deterministic_and_as_jax():
    """feature_fraction and query bagging draw as JAX draws (the first tree's
    splits equal JAX's), learn, and the same random_state gives the same
    forest bit for bit."""
    tr, va, te = _rank_data(60, seed=0), _rank_data(15, seed=1), _rank_data(15, seed=2)
    kw = dict(num_trees=8, max_depth=4, num_bins=16, learning_rate=0.2, feature_fraction=0.6,
              bagging_fraction=0.7, bagging_freq=2, random_state=11)
    m1 = T.GBDTRanker(T.GBDTConfig(**kw), device="cpu").fit(*tr, vali=va)
    m2 = T.GBDTRanker(T.GBDTConfig(**kw), device="cpu").fit(*tr, vali=va)
    assert len(m1.trees) == len(m2.trees)
    for a, b in zip(m1.trees, m2.trees):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    jm = J.TPUGBDTRanker(J.GBDTConfig(**kw)).fit(*tr, vali=va)
    np.testing.assert_array_equal(m1.trees[0][0], jm.trees[0][0])
    ndcg = T._ndcg_at_k(m1.predict(te[0]), te[1], te[2], 5)
    rand = T._ndcg_at_k(np.random.RandomState(9).randn(len(te[1])), te[1], te[2], 5)
    assert ndcg > rand + 0.2


@pytest.mark.parametrize("paras", [
    {"feature_fraction": 0.8, "bagging_fraction": 0.9, "bagging_freq": 3, "random_state": 42,
     "num_leaves": 32},
    {"lightgbm_para_dict": {"num_leaves": 400, "learning_rate": 0.05, "num_trees": 1000,
                            "objective": "lambdarank", "metric": "ndcg"},
     "custom_dict": {"custom": False, "custom_obj_id": None}},
    {"custom_dict": {"custom": True, "custom_obj_id": "listnet"}, "num_iterations": 7}])
def test_config_from_paras_as_jax(paras):
    got = T.GBDTConfig.from_paras(json.loads(json.dumps(paras)), early_stopping_rounds=9)
    want = J.GBDTConfig.from_paras(json.loads(json.dumps(paras)), early_stopping_rounds=9)
    assert vars(got) == vars(want)


# --- the flat helpers, LightGBM, settings, evaluator -------------------------------


def test_cal_metric_at_ks_as_jax():
    rng = np.random.RandomState(4)
    group = np.array([5, 1, 12, 7])
    labels = rng.randint(0, 4, group.sum()).astype(np.float32)
    preds = rng.randn(group.sum()).astype(np.float32)
    got = tev.cal_metric_at_ks(preds, labels, group, ks=(1, 3, 5, 10), device="cpu")
    want = jax_cal_metric(preds, labels, group, ks=(1, 3, 5, 10))
    for m in ("nDCG", "nERR", "AP", "P"):
        np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_libsvm_round_trip_and_lightgbm_gate(tmp_path):
    data, target, group = _rank_data(3, n=4, F=5, seed=7)
    data[0, 1] = 0.0
    path = str(tmp_path / "train.libsvm")
    lambdamart.save_libsvm(path, data, target, group)
    x, y, g = lambdamart.load_libsvm(path)
    np.testing.assert_allclose(x, data.astype(np.float32), rtol=1e-5)
    np.testing.assert_array_equal(y, target.astype(np.float32))
    np.testing.assert_array_equal(g, group)
    assert [q.shape for q in lambdamart.queries_to_flat([])] == [(0, 1), (0,), (0,)]
    if not lambdamart.HAS_LIGHTGBM:
        with pytest.raises(ImportError, match="lightgbm is not installed"):
            lambdamart.LightGBMLambdaMART().fit((data, target, group))


@pytest.mark.parametrize("model_id", settings.TREE_MODEL_IDS)
def test_settings_as_jax(model_id, tmp_path):
    """The data, eval and model settings, their grids and their strings,
    from the repository's JSON files, equal the JAX package's."""
    tree_json = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                             "Tree_Data_Eval_ScoringFunction.json")
    para_json = tree_json.replace("Tree_Data_Eval_ScoringFunction",
                                  "LightGBMLambdaMARTParameter")
    pairs = [(settings.TreeDataSetting(True, data_json=tree_json),
              jax_settings.TreeDataSetting(True, data_json=tree_json)),
             (settings.TreeEvalSetting(False, eval_json=tree_json),
              jax_settings.TreeEvalSetting(False, eval_json=tree_json))]
    def plain(d):  # each package has its own LabelType enum: compare by name
        return {k: getattr(v, "name", v) for k, v in d.items()}

    for a, b in pairs:
        assert plain(a.default_setting()) == plain(b.default_setting())
        assert [plain(d) for d in a.grid_search()] == [plain(d) for d in b.grid_search()]
    assert pairs[0][0].to_data_setting_string() == pairs[0][1].to_data_setting_string()
    assert pairs[1][0].to_eval_setting_string() == pairs[1][1].to_eval_setting_string()
    m, jm = (settings.TreeModelSetting(model_id, para_json=para_json),
             jax_settings.TreeModelSetting(model_id, para_json=para_json))
    assert m.default_para_dict() == jm.default_para_dict()
    assert m.to_para_string() == jm.to_para_string() and m.get_identifier() == jm.get_identifier()
    assert list(m.grid_search()) == list(jm.grid_search())
    with pytest.raises(ValueError, match="not a tree model id"):
        settings.TreeModelSetting("LambdaRank")


def _small_json(root, dir_output) -> str:
    """Tree JSON of the repository with 5 trees of depth 3 (8 leaves)."""
    os.makedirs(root, exist_ok=True)
    with open("configs/Tree_Data_Eval_ScoringFunction.json") as f:
        tree = json.load(f)
    tree["EvalSetting"]["dir_output"] = dir_output
    with open(os.path.join(root, "Tree_Data_Eval_ScoringFunction.json"), "w") as f:
        json.dump(tree, f)
    with open("configs/LightGBMLambdaMARTParameter.json") as f:
        para = json.load(f)
    para.update(leaves=[8], trees=[5], LR=[0.2])
    for mid in settings.TREE_MODEL_IDS:
        with open(os.path.join(root, f"{mid}Parameter.json"), "w") as f:
            json.dump(para, f)
    return root


@pytest.fixture
def in_repo(monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("model_id", settings.TREE_MODEL_IDS)
def test_ltr_main_json_grid_as_jax(model_id, tmp_path, in_repo):
    """`python -m ptranking_tpu_torch.ltr -model <tree id> -dir_json DIR` on
    the CPU: LightGBMLambdaMART falls back to the native GBDT as the JAX
    package's CLI does, the run directory has JAX's name, and the CV nDCG is
    within 0.03 of JAX's (5 trees of depth 3 on 2 folds of synthetic data;
    the sums round an ulp apart, which can move a near-tie split)."""
    for pkg in ("jax", "torch"):
        _small_json(str(tmp_path / pkg / "json"), str(tmp_path / pkg / "out"))
    want = jax_ltr.main(["-model", model_id, "-debug", "-dir_json",
                         str(tmp_path / "jax" / "json")])
    got = ltr.main(["-device", "cpu", "-model", model_id, "-debug", "-dir_json",
                    str(tmp_path / "torch" / "json")])
    assert got["nDCG"].shape == want["nDCG"].shape == (6,)
    assert np.all(np.isfinite(got["nDCG"])) and float(got["nDCG"][2]) > 0.3
    np.testing.assert_allclose(got["nDCG"], want["nDCG"], atol=0.03)
    runs = [sorted(os.path.relpath(os.path.join(r, f), tmp_path / pkg / "out")
                   for r, _, fs in os.walk(tmp_path / pkg / "out")
                   for f in fs if f.endswith(".model"))
            for pkg in ("jax", "torch")]
    assert runs[0] == runs[1] and len(runs[1]) == 2


def test_ltr_main_point_run_falls_back(tmp_path, capsys):
    """`-model LightGBMLambdaMART` without LightGBM runs the native GBDT (a
    debug point run: 2 folds, early stopping after 10 rounds)."""
    if lambdamart.HAS_LIGHTGBM:
        pytest.skip("lightgbm installed: no fallback to show")
    cv = ltr.main(["-device", "cpu", "-model", "LightGBMLambdaMART", "-data", "SyntheticMQ",
                   "--debug", "-dir_output", str(tmp_path)])
    assert "using the native TPUGBDTLambdaMART" in capsys.readouterr().out
    assert cv["nDCG"].shape == (6,) and float(cv["nDCG"][2]) > 0.3


def test_tree_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        tev.TreeLTREvaluator()
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        T.GBDTRanker(T.GBDTConfig(num_trees=1)).fit(*_rank_data(2))
