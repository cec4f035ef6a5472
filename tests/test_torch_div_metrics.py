"""The port's SRD metrics, greedy ideal rankings, diversification data and
ndeval wrapper against the JAX package's, on the same seeded numpy inputs:
alpha-(n)DCG, ERR-IA, nERR-IA and delta-alpha-DCG in value (padding
invariant), both greedy ideal rankings index for index, the synthetic
queries, the TREC Web Track loader and the bucketed batches array for
array, and ndeval built by the port's builder into build/native/."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.diversification import data as jdata
from ptranking_tpu.metrics import ndeval as jndeval
from ptranking_tpu.metrics import srd as jsrd
from ptranking_tpu_torch.diversification import data as tdata
from ptranking_tpu_torch.metrics import ndeval as tndeval
from ptranking_tpu_torch.metrics import srd as tsrd
from ptranking_tpu_torch.utils.native_build import NATIVE_BUILD_DIR, find_cxx

torch.set_num_threads(1)

KS = (1, 3, 5, 10, 20)
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, B=4, S=5, N=12, graded=False):
    """[B, S, N] coverage (a row's real docs first), a ragged doc mask (one
    row all real, one with a single doc) and a ragged subtopic mask."""
    rng = np.random.RandomState(seed)
    rele = (rng.rand(B, S, N) < 0.35).astype(np.float32)
    if graded:
        rele *= rng.randint(1, 4, size=rele.shape).astype(np.float32)
    n_docs = rng.randint(2, N + 1, size=B)
    n_docs[0], n_docs[-1] = N, 1
    n_sub = rng.randint(1, S + 1, size=B)
    dmask = np.arange(N)[None] < n_docs[:, None]
    smask = np.arange(S)[None] < n_sub[:, None]
    rele = rele * dmask[:, None, :] * smask[:, :, None]
    perm = np.stack([np.concatenate([rng.permutation(n), np.arange(n, N)]) for n in n_docs])
    sys_rele = np.take_along_axis(rele, perm[:, None, :].repeat(S, 1), -1)
    return rele, sys_rele, dmask, smask


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_srd_metrics_match_jax(seed, graded):
    rele, sys_rele, dmask, smask = _case(seed, graded=graded)
    max_label = float(rele.max())
    checks = [
        ("alpha_dcg_rankwise", (sys_rele, dmask), {"alpha": 0.5}),
        ("alpha_ndcg_at_ks", (sys_rele, rele, dmask), {"ks": KS, "alpha": 0.3}),
        ("rankwise_err_ia", (sys_rele, dmask, max_label), {}),
        ("rankwise_err_ia", (sys_rele, dmask, max_label), {"subtopic_mask": smask}),
        ("err_ia_at_ks", (sys_rele, dmask, max_label, KS), {"subtopic_mask": smask}),
        ("nerr_ia_at_ks", (sys_rele, rele, dmask, max_label, KS), {"subtopic_mask": smask}),
        ("nerr_ia_at_ks", (sys_rele, rele, dmask, max_label, KS), {}),
        ("delta_alpha_dcg", (rele, sys_rele, dmask), {"normalization": True}),
        ("delta_alpha_dcg", (rele, sys_rele, dmask), {"alpha": 0.7, "normalization": False}),
    ]
    for name, args, kw in checks:
        tensors = [a for a in args if isinstance(a, np.ndarray)]
        rest = [a for a in args if not isinstance(a, np.ndarray)]
        got = getattr(tsrd, name)(*(torch.from_numpy(a) for a in tensors), *rest,
                                  **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()}).numpy()
        want = np.asarray(getattr(jsrd, name)(*(jnp.asarray(a) for a in tensors), *rest,
                                              **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                                 else v for k, v in kw.items()}))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{name} {kw}")


def test_srd_metrics_are_padding_invariant():
    """Extra padded docs and subtopics (with garbage in them) change no real
    value, as in the JAX package's tests."""
    rele, sys_rele, dmask, smask = _case(3, N=10)
    B, S, N = rele.shape
    pad = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full((*a.shape[:-1], 6), fill, a.dtype)], axis=-1)
    rng = np.random.RandomState(1)
    big_sys = pad(sys_rele, 1.0)
    big_ideal = pad(rele, 1.0)
    big_mask = pad(dmask, False)
    big_sys = np.concatenate([big_sys, rng.rand(B, 2, N + 6).astype(np.float32)], axis=1)
    big_ideal = np.concatenate([big_ideal, np.zeros((B, 2, N + 6), np.float32)], axis=1)
    big_smask = np.concatenate([smask, np.zeros((B, 2), bool)], axis=1)
    big_sys[:, S:] *= 0.0  # padded subtopics hold no coverage
    t = torch.from_numpy
    base = tsrd.alpha_ndcg_at_ks(t(sys_rele), t(rele), t(dmask), KS)
    big = tsrd.alpha_ndcg_at_ks(t(big_sys), t(big_ideal), t(big_mask), KS)
    np.testing.assert_allclose(big.numpy(), base.numpy(), rtol=1e-6, atol=1e-7)
    base = tsrd.nerr_ia_at_ks(t(sys_rele), t(rele), t(dmask), 1.0, KS, subtopic_mask=t(smask))
    big = tsrd.nerr_ia_at_ks(t(big_sys), t(big_ideal), t(big_mask), 1.0, KS,
                             subtopic_mask=t(big_smask))
    np.testing.assert_allclose(big.numpy(), base.numpy(), rtol=1e-6, atol=1e-7)
    base = tsrd.delta_alpha_dcg(t(rele), t(sys_rele), t(dmask))
    big = tsrd.delta_alpha_dcg(t(big_ideal), t(big_sys), t(big_mask))
    np.testing.assert_allclose(big.numpy()[:, :N, :N], base.numpy(), rtol=1e-6, atol=1e-7)
    assert not big.numpy()[:, N:, :].any() and not big.numpy()[:, :, N:].any()


@pytest.mark.parametrize("seed", range(4))
def test_greedy_ideal_rankings_match_jax(seed):
    """Both greedy ideal rankings give JAX's order index for index, ties
    (duplicate columns, all-zero columns) and padded docs included."""
    rng = np.random.RandomState(seed)
    S, N = 4, 14
    rele = (rng.rand(S, N) < 0.4).astype(np.float32)
    rele[:, 3] = rele[:, 7]  # a tie between two docs
    rele[:, 5] = 0.0
    np.testing.assert_array_equal(tsrd.np_greedy_ideal_ranking(rele),
                                  jsrd.np_greedy_ideal_ranking(rele))
    np.testing.assert_array_equal(tsrd.np_greedy_ideal_ranking(rele, alpha=0.3),
                                  jsrd.np_greedy_ideal_ranking(rele, alpha=0.3))
    mask = np.arange(N) < (N - 3 * (seed % 2))
    got = tsrd.greedy_ideal_ranking(torch.from_numpy(rele), torch.from_numpy(mask))
    want = np.asarray(jsrd.greedy_ideal_ranking(jnp.asarray(rele), jnp.asarray(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if mask.all():
        np.testing.assert_array_equal(got.numpy(), tsrd.np_greedy_ideal_ranking(rele))


def test_batched_greedy_ideal_ranking_matches_jax_vmap():
    """A batch of queries (leading axis; ragged docs and subtopics, an
    all-padded row) gives jax.vmap of the JAX function, row for row."""
    import jax

    rele, _, dmask, _ = _case(5, B=5, S=4, N=13)
    rele[1, :, 2] = rele[1, :, 9]  # a tie
    dmask[3] = False
    got = tsrd.greedy_ideal_ranking(torch.from_numpy(rele), torch.from_numpy(dmask), alpha=0.4)
    want = jax.vmap(lambda r, m: jsrd.greedy_ideal_ranking(r, m, alpha=0.4))(
        jnp.asarray(rele), jnp.asarray(dmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(5):
        one = tsrd.greedy_ideal_ranking(torch.from_numpy(rele[b]), torch.from_numpy(dmask[b]),
                                        alpha=0.4)
        np.testing.assert_array_equal(one.numpy(), got[b].numpy())


# ------------------------------------------------------------------ data


def _assert_queries_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.qid == b.qid and a.docnos == b.docnos
        for x, y in ((a.q_repr, b.q_repr), (a.doc_reprs, b.doc_reprs), (a.rele_mat, b.rele_mat)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_synthetic_queries_and_batches_equal_jax():
    kw = dict(num_queries=30, num_features=12, min_docs=5, max_docs=70, seed=11)
    got, want = tdata.make_synthetic_div_queries(**kw), jdata.make_synthetic_div_queries(**kw)
    _assert_queries_equal(got, want)
    t_ds = tdata.DivBucketedDataset(got, batch_queries=4, seed=5)
    j_ds = jdata.DivBucketedDataset(want, batch_queries=4, seed=5)
    assert t_ds.doc_buckets == j_ds.doc_buckets and len(t_ds) == len(j_ds)
    for shuffle, epoch in ((False, 0), (True, 3)):
        tb, jb = list(t_ds.batches(shuffle, epoch)), list(j_ds.batches(shuffle, epoch))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            for row in range(a.q_repr.shape[0]):
                qa, qb = t_ds.query_for(a, row), j_ds.query_for(b, row)
                assert (qa is None) == (qb is None) and (qa is None or qa.qid == qb.qid)


def _write_trec_layout(root, rng, n_queries=5, D=6):
    q_reprs, d_reprs, perms, q_docs = {}, {}, {}, {}
    for qi in range(n_queries):
        qid = str(100 + qi)
        docs = [f"clueweb-{qi}-{j}" for j in range(rng.randint(4, 9))]
        q_reprs[qid] = rng.randn(D).tolist()
        for d in docs:
            d_reprs[d] = rng.randn(D).tolist()
        perms[qid] = {"permutation": docs}
        q_docs[qid] = {d: [str(s) for s in range(1, 5) if rng.rand() < 0.4] for d in docs}
    for name, obj in (("query_representation.dat", q_reprs), ("doc_representation.dat", d_reprs),
                      ("query_permutation.json", perms), ("query_doc.json", q_docs)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)
    return sorted(q_reprs)


@pytest.mark.parametrize("add_noise", [False, True])
def test_trec_loader_equals_jax(add_noise, tmp_path):
    qids = _write_trec_layout(str(tmp_path), np.random.RandomState(2))
    kw = dict(presort=True, add_noise=add_noise, std_delta=0.5, seed=9)
    _assert_queries_equal(tdata.load_trec_div_fold(str(tmp_path), qids, **kw),
                          jdata.load_trec_div_fold(str(tmp_path), qids, **kw))
    assert tdata.get_div_data_meta("WT_Div_0912_Implicit") == \
        jdata.get_div_data_meta("WT_Div_0912_Implicit")


# ---------------------------------------------------------------- ndeval


needs_cxx = pytest.mark.skipif(find_cxx() is None, reason="no C++ compiler for ndeval")


@needs_cxx
def test_ndeval_wrapper_builds_into_the_port_dir_and_equals_jax(tmp_path):
    """The port's wrapper builds the unchanged native/ndeval.cpp into
    build/native/ and parses the same CSV as the JAX package's wrapper."""
    binary = tndeval.ndeval_binary()
    assert binary == os.path.join(NATIVE_BUILD_DIR, "ndeval") and os.path.exists(binary)
    qp, rp = str(tmp_path / "q.txt"), str(tmp_path / "r.txt")
    rng = np.random.RandomState(4)
    qrows = [(t, s, f"d{t}-{j}", int(rng.rand() < 0.4))
             for t in (3, 8) for s in (1, 2, 3) for j in range(10)]
    rrows = [(t, f"d{t}-{j}", r + 1, float(10 - r))
             for t in (3, 8) for r, j in enumerate(rng.permutation(10))]
    tndeval.write_qrels(qp, qrows)
    tndeval.write_run(rp, rrows)
    with open(qp) as f, open(rp) as g:
        text = f.read(), g.read()
    jndeval.write_qrels(qp + "j", qrows)
    jndeval.write_run(rp + "j", rrows)
    with open(qp + "j") as f, open(rp + "j") as g:
        assert (f.read(), g.read()) == text
    for kw in ({}, {"alpha": 0.3, "depth": 5}, {"traditional": True, "complete": True}):
        got = tndeval.run_ndeval(qp, rp, **kw)
        assert got == jndeval.run_ndeval(qp, rp, **kw)
        assert set(got) == {"3", "8", "amean"} and np.isfinite(got["amean"]["alpha-nDCG@10"])


@needs_cxx
def test_port_alpha_ndcg_matches_ndeval(tmp_path):
    """ndeval's alpha-nDCG@5/10/20 equals the port's alpha_ndcg_at_ks when the
    run ranks the judged pool and the ideal order takes ndeval's tie-break
    (the larger docno wins)."""

    def ndeval_greedy(rele, alpha=0.5):
        S, N = rele.shape
        gain, remaining, order = np.ones(S), list(range(N)), []
        while remaining:
            best, best_s = None, -1.0
            for d in remaining:
                s = float(np.sum(gain * rele[:, d]))
                if best is None or s > best_s or (s == best_s and d > best):
                    best, best_s = d, s
            gain *= np.where(rele[:, best] > 0, 1.0 - alpha, 1.0)
            order.append(best)
            remaining.remove(best)
        return np.asarray(order)

    rng = np.random.RandomState(7)
    for case in range(4):
        S, N = rng.randint(2, 5), 24
        rele = (rng.rand(S, N) < 0.35).astype(np.float32)
        rele[rng.randint(S), rng.randint(N)] = 1.0
        sys_order, ideal_order = rng.permutation(N), ndeval_greedy(rele)
        got = tsrd.alpha_ndcg_at_ks(torch.from_numpy(rele[:, sys_order]),
                                    torch.from_numpy(rele[:, ideal_order]),
                                    torch.ones(N, dtype=torch.bool), ks=[5, 10, 20])
        qp, rp = str(tmp_path / f"q{case}.txt"), str(tmp_path / f"r{case}.txt")
        tndeval.write_qrels(qp, [(1, s + 1, f"d{d:03d}", int(rele[s, d]))
                                 for s in range(S) for d in range(N)])
        tndeval.write_run(rp, [(1, f"d{d:03d}", rank + 1, float(N - rank))
                               for rank, d in enumerate(sys_order)])
        res = tndeval.run_ndeval(qp, rp)["1"]
        np.testing.assert_allclose(got.numpy(), [res["alpha-nDCG@5"], res["alpha-nDCG@10"],
                                                 res["alpha-nDCG@20"]], atol=1e-5)
