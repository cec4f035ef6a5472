"""The port's training slice against the JAX package's: one training step of
the flagship wiring (DASALC listsf, flash attention, LambdaRank through the
fused pairwise loss) at a small size, for each optimizer; resuming from a
JAX checkpoint; the port's own checkpoints, stop guard, dropout and remat;
and the two faults repaired in the port (LayerNorm's gradient on an
all-padded row, and the eps rule of Adagrad and RMSprop)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.models import ScorerConfig as JaxScorerConfig
from ptranking_tpu.train import AdhocRanker as JaxRanker
from ptranking_tpu.train import OptimizerConfig as JaxOptimizerConfig
from ptranking_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from ptranking_tpu_torch.models import scorers as tsc
from ptranking_tpu_torch.models.scorers.nn import dropout
from ptranking_tpu_torch.train import AdhocRanker, OptimizerConfig
from ptranking_tpu_torch.types import RankingBatch

torch.set_num_threads(1)

F, B, N = 16, 3, 64
LENGTHS = (N, 23, 0)  # a full list, a ragged one and an all-padded remainder row
LR = 1e-3


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, F).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    labels = -np.sort(-rng.randint(0, 5, (B, N)).astype(np.float32), axis=1)
    x[~mask] = 0.0
    return RankingBatch(x, np.where(mask, labels, 0.0).astype(np.float32), mask)


def _listsf(**kw):
    kw = {"encoder_layers": 2, "ff_dims": (16, 16), "flash_attn": True, **kw}
    return JaxScorerConfig.default_listsf(F, **kw)


def _port_cfg(jcfg):
    return tsc.ScorerConfig(**dataclasses.asdict(jcfg))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}[{i}]")]
    return [prefix]


def _np_leaves(params_np, cfg):
    """The JAX tree's leaves in the port's order (the port's tree has the
    JAX tree's structure, keyed as the port builds it)."""
    ref = tsc.init_scorer(_port_cfg(cfg), device="meta")

    def walk(src, r):
        if isinstance(r, dict):
            return [x for k in r for x in walk(src[k], r[k])]
        if isinstance(r, list):
            return [x for s, rr in zip(src, r) for x in walk(s, rr)]
        return [np.asarray(src)]

    return walk(params_np, ref)


def _zero_gradient_slice(name):
    """Elements whose gradient is zero in exact arithmetic, so that both
    packages hold rounding noise there: the key bias (softmax is invariant to
    a shift of one query's logits) and the last bias (LambdaRank is invariant
    to a shift of every score)."""
    if name.endswith("mhsa.qkv.b"):
        return slice(F, 2 * F)
    if name == "tail_ffnns.layers[2].linear.b":
        return slice(None)
    return None


def _assert_params_match(port, jax_np, cfg, before):
    """Each parameter's update (new - old) within 1e-3 * lr + 1e-4 * |update|.
    The elements of `_zero_gradient_slice` hold rounding noise, which the
    optimizers scale (Adam's first steps to about +-lr whatever its size):
    they are held to |update| <= 1.01 * lr instead."""
    for name, t, want, old in zip(_names(port.params), tsc.tree_leaves(port.params),
                                  _np_leaves(jax_np, cfg), before):
        got = t.detach().numpy() - old
        want = want - old
        noise = _zero_gradient_slice(name)
        if noise is not None:
            assert np.all(np.abs(got[noise]) <= 1.01 * LR), name
            got, want = np.delete(got, np.arange(got.shape[0])[noise], 0), \
                np.delete(want, np.arange(want.shape[0])[noise], 0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * LR, err_msg=name)


_JAX_RUNS = {}


def _jax_run(opt, tmp_path_factory):
    """The JAX package's ranker: its .pkl at init, one step, its .pkl after
    the step, and a second step (cached per optimizer)."""
    if opt in _JAX_RUNS:
        return _JAX_RUNS[opt]
    d = tmp_path_factory.mktemp(f"jax_{opt}")
    cfg = _listsf(dropout=0.0)
    jr = JaxRanker("LambdaRank", cfg, opt_cfg=JaxOptimizerConfig(opt=opt, lr=LR)).init()
    batch = _batch()
    args = tuple(jnp.asarray(a) for a in (batch.features, batch.labels, batch.mask))
    jr.save(str(d / "init.pkl"))
    p0 = jax.tree_util.tree_map(np.asarray, jr.params)
    out = []
    for k in range(2):
        jr.params, jr.opt_state, loss = jr._compiled_step(jr.params, jr.opt_state,
                                                          jax.random.PRNGKey(k), *args)
        out.append((float(loss), jax.tree_util.tree_map(np.asarray, jr.params)))
        if k == 0:
            jr.save(str(d / "step1.pkl"))
    _JAX_RUNS[opt] = (cfg, batch, str(d / "init.pkl"), str(d / "step1.pkl"), p0, out)
    return _JAX_RUNS[opt]


def _port_step(pkl, batch):
    """The port's ranker from a JAX .pkl (params and optimizer state), with
    the fused pairwise loss, and one train_epoch over the one batch; returns
    (ranker, summed loss, params before the step)."""
    ranker = AdhocRanker.from_checkpoint(pkl, device="cpu")
    ranker.model_paras["use_pallas"] = True
    before = [t.detach().numpy().copy() for t in tsc.tree_leaves(ranker.params)]
    mean_loss, stop = ranker.train_epoch([batch], epoch_k=1)
    assert not stop
    return ranker, mean_loss * sum(1 for n in LENGTHS if n), before


@pytest.mark.parametrize("opt", ["Adagrad", "Adam", "RMS"])
def test_train_step_matches_jax(opt, tmp_path_factory):
    """One step from the same params: the loss to rtol 1e-5 and every updated
    parameter as `_assert_params_match` states."""
    cfg, batch, init_pkl, _, _, out = _jax_run(opt, tmp_path_factory)
    ranker, loss, before = _port_step(init_pkl, batch)
    np.testing.assert_allclose(loss, out[0][0], rtol=1e-5)
    _assert_params_match(ranker, out[0][1], cfg, before)


@pytest.mark.parametrize("opt", ["Adagrad", "Adam", "RMS"])
def test_jax_checkpoint_resumes_to_the_jax_next_step(opt, tmp_path_factory):
    """A .pkl the JAX package saved after one step (params and optax state,
    turned into the port's by opt_state_from_jax) resumes in the port to the
    JAX package's second step."""
    cfg, batch, _, step1_pkl, _, out = _jax_run(opt, tmp_path_factory)
    ranker, loss, before = _port_step(step1_pkl, batch)
    np.testing.assert_allclose(loss, out[1][0], rtol=1e-5)
    _assert_params_match(ranker, out[1][1], cfg, before)


def _leaves_requiring_grad(params):
    leaves = tsc.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def test_all_padded_row_gives_finite_gradients():
    """LayerNorm of an all-padded query's constant encoder output (var == 0)
    must not put NaN into the gradients."""
    cfg = _port_cfg(_listsf())
    params = tsc.init_scorer(cfg, seed=0)
    leaves = _leaves_requiring_grad(params)
    batch = _batch()
    mask = torch.from_numpy(batch.mask)
    scores = tsc.apply_scorer(params, cfg, torch.from_numpy(batch.features), mask)
    grads = torch.autograd.grad(torch.sum(torch.where(mask, scores, 0.0) ** 2), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("opt", ["Adagrad", "RMS", "Adam"])
def test_optimizer_matches_optax_at_tiny_gradients(opt):
    """Three steps at gradients of about 1e-6, where eps inside the root
    (optax, the JAX package) and outside it (torch.optim) part by O(lr) per
    step: the port follows optax to rtol 1e-5 and atol 1e-4 * lr (optax takes
    Adam's bias corrections in fp32, torch in double). torch.optim's Adagrad
    and RMSprop do not."""
    from ptranking_tpu_torch.train.optimizer import make_optimizer

    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [(rng.randn(5, 7) * 1e-6).astype(np.float32) for _ in range(3)]
    jcfg = JaxOptimizerConfig(opt=opt, lr=1e-2, weight_decay=0.0)
    tx = jax_make_optimizer(jcfg)
    p = {"w": jnp.asarray(p0)}
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, p)
        p = {"w": p["w"] + upd["w"]}
    want = np.asarray(p["w"])

    def run(optimizer_of):
        w = torch.tensor(p0, requires_grad=True)
        o = optimizer_of(w)
        for g in grads:
            w.grad = torch.from_numpy(g)
            o.step()
        return w.detach().numpy()

    got = run(lambda w: make_optimizer(OptimizerConfig(opt=opt, lr=1e-2, weight_decay=0.0), [w]))
    np.testing.assert_allclose(got - p0, want - p0, rtol=1e-5, atol=1e-6)
    if opt != "Adam":
        stock = {"Adagrad": lambda w: torch.optim.Adagrad([w], lr=1e-2),
                 "RMS": lambda w: torch.optim.RMSprop([w], lr=1e-2, alpha=0.99, eps=1e-8)}[opt]
        assert not np.allclose(run(stock) - p0, want - p0, rtol=0.05)


def _port_ranker(**kw):
    cfg = _port_cfg(_listsf(dropout=0.1))
    return AdhocRanker("LambdaRank", cfg, model_paras={"use_pallas": True},
                       opt_cfg=OptimizerConfig(opt="Adam", lr=LR), device="cpu", **kw).init()


def test_train_epoch_stops_on_poisoned_params():
    ranker = _port_ranker()
    batch = _batch()
    loss, stop = ranker.train_epoch([batch], epoch_k=1)
    assert np.isfinite(loss) and not stop
    with torch.no_grad():
        tsc.tree_leaves(ranker.params)[0].fill_(float("nan"))
    loss, stop = ranker.train_epoch([batch], epoch_k=10)
    assert np.isnan(loss) and stop


def test_pt_checkpoint_resumes_to_the_same_next_step(tmp_path):
    """Params, Adam's state and the dropout generator's state go into the
    .pt; a restored ranker takes the same next step, bit for bit."""
    ranker = _port_ranker()
    batch = _batch()
    ranker.train_epoch([batch], epoch_k=1)
    ranker.save(str(tmp_path / "r.pt"))
    again = AdhocRanker.from_checkpoint(str(tmp_path / "r.pt"), device="cpu")
    assert again.model_paras == ranker.model_paras
    assert ranker.train_epoch([batch], epoch_k=2) == again.train_epoch([batch], epoch_k=2)
    for a, b in zip(tsc.tree_leaves(ranker.params), tsc.tree_leaves(again.params)):
        assert torch.equal(a, b)


def test_dropout_keeps_one_minus_rate_scaled():
    x = torch.ones(200_000)
    y = dropout(torch.Generator().manual_seed(0), x, 0.1, True)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 4e-3  # about 6 standard deviations
    assert bool(torch.all((y == 0) | (y == torch.tensor(1.0) / 0.9)))
    assert dropout(torch.Generator(), x, 0.1, False) is x and dropout(None, x, 0.1, True) is x


def test_remat_gives_the_same_gradients_with_dropout():
    """AllRank with dense attention drops attention probabilities and both
    residuals inside each layer: with remat the recompute replays the masks
    the forward drew, so the gradients are those without remat."""
    cfg = _port_cfg(_listsf(encoder_type="AllRank", flash_attn=False, dropout=0.2))
    params = tsc.init_scorer(cfg, seed=1)
    leaves = _leaves_requiring_grad(params)
    batch = _batch()
    x, mask = torch.from_numpy(batch.features), torch.from_numpy(batch.mask)
    grads = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        scores = tsc.apply_scorer(params, dataclasses.replace(cfg, remat=remat), x, mask,
                                  training=True, gen=gen)
        grads.append(torch.autograd.grad(torch.sum(torch.where(mask, scores, 0.0) ** 2), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
