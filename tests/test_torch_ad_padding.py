"""The port's minimax machines on a batch with an all-masked query (a
bucketed batch's remainder row), batch norm on: every step of every machine
against the JAX package's on the padded batch (the draws replayed from its
key splits), and against the port's own step on the unpadded batch with the
real rows' draws, which must change no value. Then one minimax round of
every machine, streamed and from device-resident buckets, on the CPU, and
the machines' refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks
from ptranking_tpu_torch.adversarial import AD_DEFAULT_PARAS, AD_MACHINES, AdSFSetting
from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset
from ptranking_tpu_torch.models.scorers import tree_leaves
from ptranking_tpu_torch.parallel.launch import run_ranks
from test_torch_ad_machines import (F, STEPS, TOL, _assert_leaves_close, _assert_params_close,
                                    _batch, _jax_draws, _jax_step, _leaves_before, _pair,
                                    _port_step, _sf)

torch.set_num_threads(1)


@pytest.mark.parametrize("model_id", list(AD_MACHINES))
def test_all_masked_query_changes_no_value(model_id):
    """Every step of the machine, batch norm on, on the batch with an extra
    all-masked query: equal to JAX's on the padded batch, and equal to the
    port's own step on the unpadded batch with the real rows' draws (loss
    and params within 1e-6)."""
    f, l, m = _batch(pad=True)
    key = jax.random.PRNGKey(23)
    jm, padded = _pair(model_id, {}, True)
    _, plain = _pair(model_id, {}, True)
    before = _leaves_before(padded)
    for step in STEPS[model_id]:
        jf, jl, jmk = jnp.asarray(f), jnp.asarray(l), jnp.asarray(m)
        draws = {k: np.asarray(v) for k, v in
                 _jax_draws(jm, model_id, step, key, jf, jl, jmk).items()}
        want = _jax_step(jm, step, key, jf, jl, jmk)
        got = _port_step(padded, step, *(torch.from_numpy(a) for a in (f, l, m)), draws)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
        ref = _port_step(plain, step, *(torch.from_numpy(a[:-1]) for a in (f, l, m)),
                         {k: v[:-1] for k, v in draws.items()})
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        key = jax.random.fold_in(key, 1)
    _assert_params_close(jm, padded, before)
    _assert_leaves_close([tree_leaves(plain.generator.params),
                          tree_leaves(plain.discriminator.params)], padded, before, 1e-6)


@pytest.mark.parametrize("model_id", list(AD_MACHINES))
def test_minimax_round_streamed_and_resident(model_id):
    """One round (DG, 1-1) from batches and from device-resident buckets on
    the CPU: no stop, finite players, and the resident round copies one index
    array a chunk of scan_steps batches for both passes."""
    qs = make_synthetic_queries(num_queries=24, num_features=F, seed=3, min_docs=4, max_docs=30)
    ds = BucketedDataset(qs, batch_docs=64, num_features=F)
    res = DeviceResidentDataset(ds, device="cpu")
    copies = []
    real = res.index_to_device
    res.index_to_device = lambda idx: copies.append(idx.shape) or real(idx)
    for data in (list(ds.batches(shuffle=True, epoch=1)), res):
        tm = AD_MACHINES[model_id](sf_para=_sf(AdSFSetting, False),
                                   ad_para_dict=dict(AD_DEFAULT_PARAS[model_id], scan_steps=2),
                                   seed=4, device="cpu")
        assert tm.mini_max_train(data, epoch_k=1) is False
        b = next(iter(ds.batches()))
        for player in (tm.generator, tm.discriminator):
            s = player.predict(b).numpy()
            assert np.all(np.isfinite(np.where(b.mask, s, 0.0)))
    assert copies and all(s[0] <= 2 for s in copies)
    assert len(copies) == sum(1 for _ in res.epoch_index_chunks(True, 1, 2))


def test_machines_refuse_a_mesh_and_need_a_device():
    sf = _sf(AdSFSetting, False)
    # a machine on a mesh's `seq` axis: 2 gloo ranks repeat each other's
    # rows and give the one-device machine's nDCG@5 within 1e-5
    (got, _) = run_ranks(torch_parallel_ranks.seq_branches, 2, (None, {"epochs": 1}),
                         timeout_s=120, join_timeout_s=300)
    want = torch_parallel_ranks.run_machine(None, epochs=1)
    for name in ("G", "D"):
        np.testing.assert_allclose(got["irgan"][name], want[name], atol=1e-5, err_msg=name)
    # a data axis needs the process group of its ranks
    with pytest.raises(RuntimeError, match="process group"):
        AD_MACHINES["IRGAN_Point"](sf_para=sf, ad_para_dict={}, mesh={"data": 1, "seq": 2},
                                   device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        AD_MACHINES["IRGAN_Point"](sf_para=sf, ad_para_dict={}, mesh={"data": 2}, device="cpu")
    with pytest.raises(ValueError, match="apply_tl_af"):
        AD_MACHINES["IRGAN_Point"](
            sf_para=dict(sf, scorer=dataclasses.replace(sf["scorer"], apply_tl_af=False)),
            ad_para_dict={}, device="cpu")
    with pytest.raises(ValueError, match="truth_sampling"):
        AD_MACHINES["IRGAN_Pair"](sf_para=sf, ad_para_dict={"truth_sampling": "x"}, device="cpu")
