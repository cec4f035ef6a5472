"""The port's context-parallel functions (ptranking_tpu_torch/parallel/ring.py
and ot.py) against the JAX package, on 4 gloo ranks on the CPU, in one group
with two meshes, {seq: 4} and {data: 2, seq: 2}, at tests/test_parallel.py's
shapes (a batch of 4 where it takes 3, so that it splits over `data`).

Each rank takes its (rows, docs) block of the same numpy inputs; a loss's
value is its data line's, summed here over the lines, and the score
gradients of the blocks are joined into the whole array. The JAX side:
  * attention: JAX's `reference_attention` (its ring and Ulysses attention
    equal it, tests/test_parallel.py) and `jax.grad` through it;
  * `ring_lambda_loss`: JAX's own, on conftest's 8-device CPU mesh
    ({data 1, model 2, seq 4}, as tests/test_parallel.py:271);
  * the other losses: JAX's dense losses (`lambda_loss`, `approx_ndcg`,
    `soft_rank`, `neural_ndcg`, `wass_rank`), which compile faster than the
    JAX ring functions and which those equal (tests/test_parallel.py).
Tolerances: values rtol 1e-5, score gradients rtol 1e-4 and atol 1e-6 (the
JAX package's bar, tests/test_parallel.py:710-713); attention outputs atol
1e-5 and q, k, v gradients rtol 1e-4, atol 1e-5. EntropicOT differentiates
through 20 iterations of logits divided by lam = 0.1, where the two
packages' dense losses already part by up to half that bar (9.0e-7 in the
gradient, measured on these inputs): its gradients are held to the port's
dense wass_rank at the bar and to JAX's at twice it.

`sdpa_block` and `online_combine` are held against JAX's in this process.
One spawn runs every case (tests/torch_parallel_ranks.py::ring_cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ptranking_tpu.losses.listwise import approx_ndcg, lambda_loss, neural_ndcg, soft_rank
from ptranking_tpu.losses.wassrank import wass_rank
from ptranking_tpu.ops import attention as jatt
from ptranking_tpu.parallel.mesh import MeshConfig, make_mesh
from ptranking_tpu.parallel.ring import reference_attention, ring_lambda_loss
from ptranking_tpu_torch.losses.wassrank import wass_rank as port_wass_rank
from ptranking_tpu_torch.ops.attention import online_combine, sdpa_block
from ptranking_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
NEURAL_KW = [dict(temperature=1.0, top_k=None, sinkhorn_iters=5),
             dict(temperature=1.0, top_k=5, sinkhorn_iters=5),
             dict(temperature=0.5, top_k=None, sinkhorn_iters=0)]
# (mode, cost, smoothing): tests/test_parallel.py:695-698
WASS_KW = [dict(mode=m, sh_itr=20, lam=0.1, smooth_type=s, cost_type=c) for m, c, s in (
    ("SinkhornOT", "eg", "ST"), ("SinkhornOT", "eg", "NG"), ("SinkhornOT", "p1", "ST"),
    ("SinkhornOT", "ddg", "ST"), ("EntropicOT", "eg", "ST"), ("EntropicOT", "eg", "NG"),
    ("EntropicOT", "dg", "ST"))]
LAMBDALOSS = {"loss2": dict(loss_type="NDCG_Loss2", k=8),
              "loss2pp": dict(loss_type="NDCG_Loss2++", k=8, mu=5.0),
              "loss1": dict(loss_type="NDCG_Loss1", k=8)}


def _inputs():
    rng = np.random.RandomState(0)
    B, H, N, d = 2, 4, 32, 8
    att_mask = np.ones((B, N), bool)
    att_mask[0, 20:] = False
    attention = {n: rng.randn(B, H, N, d).astype(np.float32) for n in ("q", "k", "v")}
    attention["mask"] = att_mask

    # ring_lambda_loss: scores sorted descending, labels, gain/IDCG, a ragged row
    B, N = 4, 32
    scores = -np.sort(-rng.randn(B, N), axis=1).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 25:] = False
    labels = np.where(mask, rng.randint(0, 4, (B, N)), 0).astype(np.float32)
    gains = 2.0 ** labels - 1.0
    disc = 1.0 / np.log2(np.arange(N) + 2.0)
    idcg = np.sum(np.where(mask, -np.sort(-gains, axis=1) * disc, 0.0), axis=1, keepdims=True)
    n_gains = np.where(mask, gains / np.maximum(idcg, 1e-8), 0.0).astype(np.float32)
    lam = {"scores": scores, "labels": labels, "n_gains": n_gains, "mask": mask}

    # LambdaLoss over ideal-ordered labels (the trainer presorts), and the
    # saturation case (tests/test_parallel.py:730): score gaps of about 30
    lambdaloss = {}
    for name, kw in LAMBDALOSS.items():
        s = rng.randn(4, 16).astype(np.float32)
        lab = -np.sort(-rng.randint(0, 4, (4, 16)), axis=1).astype(np.float32)
        m = np.arange(16)[None, :] < np.asarray([16, 11, 0, 7])[:, None]
        lambdaloss[name] = {"scores": s, "labels": np.where(m, lab, 0.0).astype(np.float32),
                            "mask": m, "kw": dict(kw, sigma=1.0)}
    s = (rng.randn(2, 16) * 30.0).astype(np.float32)
    lab = -np.sort(-rng.randint(0, 4, (2, 16)), axis=1).astype(np.float32)
    lambdaloss["saturation"] = {"scores": s, "labels": lab, "mask": np.ones((2, 16), bool),
                                "kw": dict(loss_type="NDCG_Loss2", k=10, sigma=1.0)}

    # the listwise losses: tests/test_parallel.py:660-665's ragged batch
    B, N = 4, 16
    mask = np.arange(N)[None, :] < np.asarray([16, 13, 0, 9])[:, None]
    labels = -np.sort(-rng.randint(0, 3, (B, N)), axis=1).astype(np.float32)
    listwise = {"scores": rng.randn(B, N).astype(np.float32), "mask": mask,
                "labels": np.where(mask, labels, 0.0).astype(np.float32)}
    return {"attention": attention, "lambda": lam, "lambdaloss": lambdaloss,
            "listwise": listwise, "neural_kw": NEURAL_KW, "wass_kw": WASS_KW}


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    out = run_ranks(ranks.ring_cases, 4, (inputs,), timeout_s=120, join_timeout_s=300)
    return {"inputs": inputs, "ranks": out}


def _joined(runs, mesh, name):
    """(the lines' summed value, the ranks' gradient blocks joined) of a loss."""
    value, grad = 0.0, None
    seen = set()
    for out in runs["ranks"]:
        v, g, (r0, r1, d0, d1) = out[mesh][name]
        if (r0, r1) not in seen:  # one value a data line
            seen.add((r0, r1))
            value += v
        if grad is None:
            grad = np.zeros((g.shape[0] * ranks.CP_MESHES[mesh][0], g.shape[1]
                             * ranks.CP_MESHES[mesh][1]), np.float32)
        grad[r0:r1, d0:d1] = g
    return value, grad


_JAX = {}  # a case's JAX value and gradient, made once for both meshes


def _jax_value_and_grad(name, fn, scores):
    if name not in _JAX:
        v, g = jax.value_and_grad(fn)(jnp.asarray(scores))
        _JAX[name] = float(v), np.asarray(g)
    return _JAX[name]


def _check(runs, mesh, name, fn, scores, grad_scale=1.0):
    want_v, want_g = _jax_value_and_grad(name, fn, scores)
    got_v, got_g = _joined(runs, mesh, name)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, **{k: grad_scale * t for k, t in LOSS_TOL.items()})


MESHES = list(ranks.CP_MESHES)


def test_sdpa_block_and_online_combine_match_jax():
    """A block of real keys, a block with every key masked (logit -1e9) and
    the fold from mx = -inf: num, denom, m and the combined output equal
    JAX's within 1e-6, in fp32 and with bf16 inputs (probabilities rounded
    to bf16 before p v)."""
    rng = np.random.RandomState(3)
    q, k1, v1, k2, v2 = (rng.randn(2, 3, 5, 8).astype(np.float32) for _ in range(5))
    m1 = np.ones((2, 5), bool)
    m1[1, 2:] = False
    m2 = np.zeros((2, 5), bool)
    scale = 1.0 / np.sqrt(8.0)
    for dtype in (torch.float32, torch.bfloat16):
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        tt = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
        jj = lambda a: jnp.asarray(a, jd)  # noqa: E731
        init_t = (torch.zeros(2, 3, 5, 8), torch.zeros(2, 3, 5), torch.full((2, 3, 5), -np.inf))
        init_j = (jnp.zeros((2, 3, 5, 8)), jnp.zeros((2, 3, 5)), jnp.full((2, 3, 5), -jnp.inf))
        acc_t, acc_j = init_t, init_j
        for k, v, m in ((k1, v1, m1), (k2, v2, m2)):
            part_t = sdpa_block(tt(q), tt(k), tt(v), torch.from_numpy(m), scale)
            part_j = jatt.sdpa_block(jj(q), jj(k), jj(v), jnp.asarray(m), scale)
            for a, b in zip(part_t, part_j):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
            acc_t = online_combine(*acc_t, *part_t)
            acc_j = jatt.online_combine(*acc_j, *part_j)
        for a, b in zip(acc_t, acc_j):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_matches_jax(runs, mesh, impl):
    """Ring and Ulysses attention on the rank's blocks against JAX's
    reference attention: outputs, and the q, k, v gradients of
    sum(out^2 over real queries) joined from the blocks."""
    att = runs["inputs"]["attention"]
    q, k, v = (jnp.asarray(att[n]) for n in ("q", "k", "v"))
    mask = jnp.asarray(att["mask"])
    weight = mask[:, None, :, None]
    want = np.asarray(reference_attention(q, k, v, mask))
    grads = jax.grad(lambda q, k, v: jnp.sum(reference_attention(q, k, v, mask) ** 2 * weight),
                     argnums=(0, 1, 2))(q, k, v)
    got_out = np.zeros_like(want)
    got = [np.zeros_like(want) for _ in range(3)]
    for out in runs["ranks"]:
        res = out[mesh][impl]
        r0, r1, d0, d1 = res["where"]
        got_out[r0:r1, :, d0:d1] = res["out"]
        for full, g in zip(got, res["grads"]):
            full[r0:r1, :, d0:d1] = g
    np.testing.assert_allclose(got_out, want, atol=1e-5)
    for full, g, name in zip(got, grads, "qkv"):
        np.testing.assert_allclose(full, np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("weighted", [True, False])
def test_ring_lambda_loss_matches_jax(runs, mesh, weighted):
    """LambdaRank's (weighted) and RankNet's (unweighted) ring pair loss
    against JAX's ring_lambda_loss on its CPU mesh."""
    lam = runs["inputs"]["lambda"]
    jmesh = make_mesh(MeshConfig(data=1, model=2, seq=4))
    labels, n_gains, mask = (jnp.asarray(lam[n]) for n in ("labels", "n_gains", "mask"))
    if not weighted:
        n_gains = jnp.zeros_like(n_gains)
    _check(runs, mesh, f"lambda_{weighted}",
           lambda s: ring_lambda_loss(s, labels, n_gains, mask, jmesh, weighted=weighted),
           lam["scores"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(LAMBDALOSS) + ["saturation"])
def test_ring_lambdaloss_matches_jax(runs, mesh, name):
    """ring_lambdaloss after the trainer's gather and whole sort, against
    JAX's dense lambda_loss: the three loss types with an all-padded row,
    and the saturation case, where a ring eps other than the dense EPSILON
    parts the loss and the gradients (tests/test_parallel.py:730)."""
    case = runs["inputs"]["lambdaloss"][name]
    labels, mask = jnp.asarray(case["labels"]), jnp.asarray(case["mask"])
    _check(runs, mesh, name, lambda s: lambda_loss(s, labels, mask, **case["kw"]),
           case["scores"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["approx_ndcg", "soft_rank_None", "soft_rank_5"])
def test_ring_rank_sum_losses_match_jax(runs, mesh, name):
    """ApproxNDCG and SoftRank (top_k on global positions) against JAX's
    dense losses, on the ragged batch with an all-padded row."""
    lst = runs["inputs"]["listwise"]
    labels, mask = jnp.asarray(lst["labels"]), jnp.asarray(lst["mask"])
    if name == "approx_ndcg":
        fn = lambda s: approx_ndcg(s, labels, mask, alpha=10.0)  # noqa: E731
    else:
        top_k = None if name.endswith("None") else 5
        fn = lambda s: soft_rank(s, labels, mask, delta=2.0, top_k=top_k)  # noqa: E731
    _check(runs, mesh, name, fn, lst["scores"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("i", range(len(NEURAL_KW)))
def test_ring_neural_ndcg_matches_jax(runs, mesh, i):
    """Rank-row-sharded NeuralNDCG against JAX's dense neural_ndcg
    (tests/test_parallel.py:653): top_k, raw NeuralSort (no scaling round),
    a temperature of 0.5, an all-padded row."""
    lst = runs["inputs"]["listwise"]
    labels, mask = jnp.asarray(lst["labels"]), jnp.asarray(lst["mask"])
    _check(runs, mesh, f"neural_{i}", lambda s: neural_ndcg(s, labels, mask, **NEURAL_KW[i]),
           lst["scores"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("i", range(len(WASS_KW)))
def test_cp_wass_rank_matches_jax(runs, mesh, i):
    """The doc-sharded Sinkhorn against JAX's dense wass_rank in both OT
    modes, over cost types and both smoothings (tests/test_parallel.py:683):
    the all-padded row stays out of the mean and has finite gradients."""
    lst = runs["inputs"]["listwise"]
    kw = WASS_KW[i]
    labels, mask = jnp.asarray(lst["labels"]), jnp.asarray(lst["mask"])
    entropic = kw["mode"] == "EntropicOT"
    _check(runs, mesh, f"wass_{i}", lambda s: wass_rank(s, labels, mask, **kw), lst["scores"],
           grad_scale=2.0 if entropic else 1.0)
    _, grad = _joined(runs, mesh, f"wass_{i}")
    assert np.all(np.isfinite(grad)) and np.all(grad[2] == 0.0)
    if entropic:
        s = torch.from_numpy(lst["scores"]).requires_grad_()
        port_wass_rank(s, torch.from_numpy(lst["labels"]), torch.from_numpy(lst["mask"]),
                       **kw).backward()
        np.testing.assert_allclose(grad, s.grad.numpy(), **LOSS_TOL)
