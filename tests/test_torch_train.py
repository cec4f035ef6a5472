"""The port's training slice against the JAX package's: one training step of
the flagship wiring (DASALC listsf, flash attention, LambdaRank through the
fused pairwise loss) at a small size, for each optimizer; resuming from a
JAX checkpoint; the port's own checkpoints, stop guard, dropout and remat;
and the two faults repaired in the port (LayerNorm's gradient on an
all-padded row, and the eps rule of Adagrad and RMSprop). Then the WassRank
and evaluation slice: a WassRank step and its gradients (pointsf and a small
listsf) and `evaluate`, both against the JAX package from carried-over
params; a stochastic loss (ListMLE) in the step; a WassRank `.pt` resume."""

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


def test_check_epoch_guards_every_batch_as_jax_does():
    """A check epoch guards each batch before its step: the first batch (a
    NaN label) passes its guard and its step poisons the params, so the
    second batch's guard stops the epoch, in the port as in the JAX
    package."""
    poisoned = _batch()
    poisoned.labels[0, 0] = np.nan
    batches = [poisoned, _batch(seed=1)]
    jr = JaxRanker("LambdaRank", _listsf(dropout=0.0),
                   opt_cfg=JaxOptimizerConfig(opt="Adam", lr=LR)).init()
    jax_loss, jax_stop = jr.train_epoch(batches, epoch_k=10)
    loss, stop = _port_ranker().train_epoch(batches, epoch_k=10)
    assert (np.isnan(loss), stop) == (np.isnan(jax_loss), jax_stop) == (True, True)


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


# ------------------------------------------------- WassRank, evaluate, ListMLE

WASS_CFGS = {
    "pointsf": lambda: JaxScorerConfig(sf_id="pointsf", num_features=F, h_dim=16, num_layers=3,
                                       dropout=0.0),
    "listsf": lambda: _listsf(dropout=0.0),
}
# per parameter tensor ||port - jax|| / max(||jax||, 1e-2 * the largest ||jax||):
# fp32 on both sides, through 20 Sinkhorn iterations whose log-scalings reach
# the hundreds under the `eg` cost; the worst seen is 2e-5 (listsf) and 3e-6
# (pointsf), held with a margin
WASS_GRAD_TOL = 2e-4


@pytest.mark.parametrize("sf", sorted(WASS_CFGS))
def test_wassrank_step_matches_jax(sf, tmp_path):
    """From a JAX WassRank ranker's params, carried across through its .pkl:
    the same loss, the same gradients per parameter tensor (WASS_GRAD_TOL) and
    the same first Adagrad step as `AdhocRanker._compiled_step`."""
    from ptranking_tpu.models import apply_scorer as jax_apply_scorer

    cfg = WASS_CFGS[sf]()
    jr = JaxRanker("WassRank", cfg, opt_cfg=JaxOptimizerConfig(opt="Adagrad", lr=LR)).init()
    jr.save(str(tmp_path / "init.pkl"))
    batch = _batch()
    args = tuple(jnp.asarray(a) for a in (batch.features, batch.labels, batch.mask))

    def loss_of(p):
        scores = jax_apply_scorer(p, cfg, args[0], args[2], training=True,
                                  key=jax.random.PRNGKey(0))
        return jr.loss_fn(scores, args[1], args[2], **jr.model_paras)

    want_loss, want_grads = jax.value_and_grad(loss_of)(jr.params)
    want_grads = _np_leaves(jax.tree_util.tree_map(np.asarray, want_grads), cfg)

    ranker = AdhocRanker.from_checkpoint(str(tmp_path / "init.pkl"), device="cpu")
    assert ranker.model_id == "WassRank" and ranker.model_paras["sh_itr"] == 20
    leaves = tsc.tree_leaves(ranker.params)
    mask = torch.from_numpy(batch.mask)
    scores = tsc.apply_scorer(ranker.params, ranker.scorer_cfg, torch.from_numpy(batch.features),
                              mask, training=True)
    from ptranking_tpu_torch.losses import get_loss

    loss = get_loss("WassRank")(scores, torch.from_numpy(batch.labels), mask, **ranker.model_paras)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    floor = 1e-2 * max(np.linalg.norm(w) for w in want_grads)
    for name, g, w in zip(_names(ranker.params), grads, want_grads):
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), floor)
        assert rel <= WASS_GRAD_TOL, (name, rel)

    before = [t.detach().numpy().copy() for t in leaves]
    jparams, _, jloss = jr._compiled_step(jr.params, jr.opt_state, jax.random.PRNGKey(0), *args)
    mean_loss, stop = ranker.train_epoch([batch], epoch_k=1)
    assert not stop
    np.testing.assert_allclose(mean_loss * sum(1 for n in LENGTHS if n), float(jloss), rtol=1e-5)
    # Adagrad's first step is -lr * g' / sqrt(g'^2 + 1e-10) with g' = g + wd * p:
    # where |g'| is near 1e-5 it magnifies the gradient's fp32 rounding, so
    # each package's step is held to the formula on its own gradients (the
    # gradients themselves were held together above). A bias in front of a
    # BatchNorm has an exactly zero gradient: such a tensor (gradient norm
    # under 1e-4 of the largest) holds rounding noise, which differs between
    # two runs of one package, and its step is only held to |step| <= 1.01 * lr.
    wd = ranker.opt_cfg.weight_decay
    jax_after = _np_leaves(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    noise_floor = 1e-4 * max(np.linalg.norm(w) for w in want_grads)
    for name, t, old, g, jnew, jg in zip(_names(ranker.params), leaves, before, grads, jax_after,
                                         want_grads):
        for new, grad in ((t.detach().numpy(), g), (jnew, jg)):
            assert np.all(np.abs(new - old) <= 1.01 * LR), name
            if np.linalg.norm(jg) < noise_floor:
                continue
            full = grad + wd * old
            np.testing.assert_allclose(new - old, -LR * full / np.sqrt(full * full + 1e-10),
                                       rtol=1e-3, atol=2e-2 * LR, err_msg=name)


def _eval_batches():
    """Three batches of other shapes, ragged, with all-padded remainder rows."""
    out = []
    for seed, (b, n, lengths) in enumerate([(3, 64, (64, 23, 0)), (4, 32, (32, 7, 1, 0)),
                                            (2, 128, (100, 128))]):
        rng = np.random.RandomState(10 + seed)
        mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
        x = rng.randn(b, n, F).astype(np.float32)
        x[~mask] = 0.0
        labels = np.where(mask, rng.randint(0, 5, (b, n)), 0).astype(np.float32)
        out.append(RankingBatch(x, labels, mask))
    return out


@pytest.mark.parametrize("sf", sorted(WASS_CFGS))
def test_evaluate_matches_jax(sf, tmp_path):
    """`evaluate` (and `validation`, `evaluate_per_query`) on the same params
    and batches as the JAX package's, to 1e-5: metric means over the real
    queries, all-padded rows not counted."""
    cfg = WASS_CFGS[sf]()
    jr = JaxRanker("WassRank", cfg).init()
    jr.save(str(tmp_path / "init.pkl"))
    ranker = AdhocRanker.from_checkpoint(str(tmp_path / "init.pkl"), device="cpu")
    batches = _eval_batches()
    ks = (1, 3, 5, 10, 20, 50)
    want = jr.evaluate(iter(batches), ks=ks)
    got = ranker.evaluate(iter(batches), ks=ks)
    assert sorted(got) == sorted(want) == ["AP", "P", "nDCG", "nERR"]
    for m in want:
        assert got[m].shape == (len(ks),)
        np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=1e-5, atol=1e-5, err_msg=m)
    assert got["nDCG"][0] > 0.0

    class Dataset:  # an object with .batches() is accepted too
        def batches(self):
            return iter(batches)

    np.testing.assert_allclose(ranker.validation(Dataset(), k=5, metric="nDCG"),
                               jr.validation(iter(batches), k=5, metric="nDCG"),
                               rtol=1e-5, atol=1e-5)
    per_query = ranker.evaluate_per_query(iter(batches), ks=ks)
    want_pq = jr.evaluate_per_query(iter(batches), ks=ks)
    for m in want_pq:
        assert per_query[m].shape == (7, len(ks))  # 7 real queries of 9 rows
        np.testing.assert_allclose(per_query[m], want_pq[m], rtol=1e-5, atol=1e-5, err_msg=m)
    empty = ranker.evaluate([], ks=(1, 5))
    assert all(not empty[m].any() and empty[m].shape == (2,) for m in empty)


def _zoo_ranker(model_id, **kw):
    return AdhocRanker(model_id, _port_cfg(_listsf(dropout=0.1)),
                       opt_cfg=OptimizerConfig(opt="Adam", lr=LR), device="cpu", **kw).init()


def test_stochastic_loss_trains_and_repeats_from_the_seed():
    """ListMLE draws its tie-breaking noise from the ranker's generator, after
    the scorer's dropout draws: steps run, the loss is finite, the same seed
    gives the same steps and another seed other ones."""
    batch = _batch()
    runs = []
    for seed in (1, 1, 2):
        ranker = _zoo_ranker("ListMLE", seed=seed)
        losses = [ranker.train_epoch([batch, batch], epoch_k=k)[0] for k in (1, 2)]
        assert all(np.isfinite(l) for l in losses)
        runs.append((losses, [t.detach().clone() for t in tsc.tree_leaves(ranker.params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]


def test_wassrank_pt_checkpoint_resumes_to_the_same_next_step(tmp_path):
    ranker = _zoo_ranker("WassRank")
    batch = _batch()
    ranker.train_epoch([batch], epoch_k=1)
    ranker.save(str(tmp_path / "w.pt"))
    again = AdhocRanker.from_checkpoint(str(tmp_path / "w.pt"), device="cpu")
    assert again.model_id == "WassRank" and again.model_paras == ranker.model_paras
    assert ranker.train_epoch([batch], epoch_k=2) == again.train_epoch([batch], epoch_k=2)
    for a, b in zip(tsc.tree_leaves(ranker.params), tsc.tree_leaves(again.params)):
        assert torch.equal(a, b)
    before = ranker.evaluate([batch])
    after = again.evaluate([batch])
    for m in before:
        np.testing.assert_array_equal(before[m], after[m])


def test_unknown_model_id_raises_at_construction_as_jax_does():
    """An id the loss registry lacks raises KeyError when the ranker is
    built, in the port as in the JAX package, before any init or step."""
    with pytest.raises(KeyError):
        JaxRanker("TwinRank", _listsf())
    with pytest.raises(KeyError):
        AdhocRanker("TwinRank", _port_cfg(_listsf()), device="cpu")
