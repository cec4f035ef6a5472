"""IRFGAN: f-divergence adversarial LTR (point / pair / list).

The port's copy of ptranking_tpu/adversarial/irfgan.py (reference
ptranking/ltr_adversarial/{pointwise/irfgan_point.py, pairwise/
irfgan_pair.py, listwise/irfgan_list.py}): the variational f-GAN objective
    D: min  E_fake[f*(T(D))] - E_true[T(D)]
    G: min -E_fake[log q(x) * f*(T(D(x)))]
with (T, f*) = (activation, conjugate) per divergence
(util/f_divergence.py:9-76). Sampling mechanics mirror the IRGAN machines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ptranking_tpu_torch.adversarial.base import (AdversarialMachine, draw, gather_docs,
                                                  masked_mean, num_pos)
from ptranking_tpu_torch.adversarial.irgan import _ListSampling, _rows, init_minimax
from ptranking_tpu_torch.adversarial.util import (
    categorical,
    get_f_divergence_functions,
    log_ranking_prob_pl,
    sample_categorical_masked,
    sample_uniform_positions,
    weighted_mean,
)
from ptranking_tpu_torch.ops import masked_softmax
from ptranking_tpu_torch.parallel.collectives import global_count


def _init_f_div(machine, ad_para_dict):
    machine.f_div_id = ad_para_dict.get("f_div_id", "KL")
    machine.activation_f, machine.conjugate_f = get_f_divergence_functions(machine.f_div_id)


def _d_loss(machine, t_true, t_fake, m) -> torch.Tensor:
    """The variational D objective over the rows of `m`:
    (sum conj(act(t_fake)) - sum act(t_true)) / max(count, 1)."""
    act, conj = machine.activation_f, machine.conjugate_f
    return (torch.sum(torch.where(m, conj(act(t_fake)), 0.0))
            - torch.sum(torch.where(m, act(t_true), 0.0))) / torch.clamp(
                global_count(torch.sum(m)), min=1).float()


class IRFGAN_Point(AdversarialMachine):
    """(reference irfgan_point.py). True docs: uniform positives; fake docs:
    softmax(G) samples. D minimises conj(act(fake)) - act(true); G REINFORCE
    with conj(act(D(fake))) rewards."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        _init_f_div(self, ad_para_dict)
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=17, temperature=None)

    def _d_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: pos_unif [B, S], neg_idx [B, S]."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S = self.samples_per_query
        npos = num_pos(labels, mask)
        pos_idx = sample_uniform_positions(npos, S, N, self._gen, draw(draws, "pos_unif"))
        neg_idx = sample_categorical_masked(g.predict_scaled(features, mask), mask, S,
                                            gen=self._gen, idx=draw(draws, "neg_idx"))
        true_docs, fake_docs = gather_docs(features, pos_idx), gather_docs(features, neg_idx)
        smask = _rows(npos >= 1, S)
        return d.update(lambda: _d_loss(self, d.forward(true_docs, smask),
                                        d.forward(fake_docs, smask), smask))

    def _g_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: neg_unif [B, N] (the Gumbel top-k's uniforms)."""
        g, d = self.generator, self.discriminator
        S = self.samples_per_query
        act, conj = self.activation_f, self.conjugate_f
        valid_q = num_pos(labels, mask) >= 1

        def loss_of():
            g_scores = g.scaled(g.forward(features, mask))
            g_probs = masked_softmax(g_scores, mask)
            neg_idx = sample_categorical_masked(g_scores, mask, S, replacement=False,
                                                gen=self._gen, unif=draw(draws, "neg_unif"))
            gp = torch.gather(g_probs, 1, neg_idx)
            # without-replacement sampling can exhaust a short list: the
            # Gumbel-top-k tail then points at pad docs (reference caps at
            # valid_num per query, irfgan_point.py:192): mask them out
            picked_real = torch.gather(mask, 1, neg_idx)
            smask = _rows(valid_q, neg_idx.shape[1]) & picked_real
            reward = conj(act(d.predict_raw(gather_docs(features, neg_idx), smask)))
            return -masked_mean(torch.log(torch.clamp(gp, min=1e-20)) * reward, smask)

        return g.update(loss_of)


class IRFGAN_Pair(AdversarialMachine):
    """(reference irfgan_pair.py:96-174). True pairs ~ position-discounted
    label gaps; fake pairs ~ BT(G score diffs) over the flattened pair axis.
    D on pairwise score DIFFS with the f-div objective; G weights log BT
    probs by conj(act(.)). One joint step a batch: D first, then G against
    the UPDATED D."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        _init_f_div(self, ad_para_dict)
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=19, temperature=None)

    @staticmethod
    def _true_pair_logits(labels, mask):
        """Position-discounted positive label gaps as pair sampling logits
        (reference get_weighted_clipped_pos_diffs, pair_sampling.py:26-48),
        and the queries that have a pair."""
        n = labels.shape[-1]
        diffs = torch.clamp(labels[..., :, None] - labels[..., None, :], min=0.0)
        disc = 1.0 / torch.log2(2.0 + torch.arange(n, device=labels.device, dtype=labels.dtype))
        w = diffs * disc[None, :, None] * disc[None, None, :]
        w = torch.where(mask[..., :, None] & mask[..., None, :], w, 0.0)
        return torch.log(torch.clamp(w, min=1e-20)), torch.sum(w, dim=(-2, -1)) > 0

    def _joint_step(self, features, labels, mask, draws=None):
        """(d_loss, g_loss) on the device. Draws: true_idx, fake_idx [B, S]
        (head * N + tail over the flattened pair axis)."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S = self.samples_per_query
        act, conj = self.activation_f, self.conjugate_f
        true_logits, has_pairs = self._true_pair_logits(labels, mask)
        true_flat = categorical(true_logits.reshape(B, N * N), S, self._gen,
                                draw(draws, "true_idx"))
        g_scores = g.predict_scaled(features, mask)
        bt = F.logsigmoid(g_scores[..., :, None] - g_scores[..., None, :])
        bt = torch.where(mask[..., :, None] & mask[..., None, :], bt, -1e30)
        fake_flat = categorical(bt.reshape(B, N * N), S, self._gen, draw(draws, "fake_idx"))
        th, tt, fh, ft = (gather_docs(features, i)
                          for i in (true_flat // N, true_flat % N, fake_flat // N, fake_flat % N))
        smask = _rows(has_pairs, S)

        d_loss = d.update(lambda: _d_loss(self, d.forward(th, smask) - d.forward(tt, smask),
                                          d.forward(fh, smask) - d.forward(ft, smask), smask))

        def g_loss_of():
            gs = g.scaled(g.forward(features, mask))
            log_bt = F.logsigmoid(gs[..., :, None] - gs[..., None, :])
            lp = torch.gather(log_bt.reshape(B, N * N), 1, fake_flat)
            reward = conj(act(d.predict_raw(fh, smask) - d.predict_raw(ft, smask)))
            return -masked_mean(lp * reward, smask)

        return d_loss, g.update(g_loss_of)

    def mini_max_train(self, train_data=None, epoch_k: int = 0, shuffle: bool = True) -> bool:
        """One joint pass (the JAX package's own loop, irfgan.py:236-262):
        a joint step a batch; True when a chunk's G loss went non-finite."""
        return self._fused_pass(lambda *batch: self._joint_step(*batch)[1],
                                self._epoch_data(train_data, epoch_k, shuffle))


class IRFGAN_List(_ListSampling, AdversarialMachine):
    """(reference irfgan_list.py). IRGAN_List sampling with the f-div
    objective on PL ranking log-probs of truth vs generated sub-rankings."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        _init_f_div(self, ad_para_dict)
        self.top_k = ad_para_dict.get("top_k", 5)
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=23, temperature=0.5)

    def _d_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: gen_unif, std_unif [B, S, N]."""
        d = self.discriminator
        act, conj = self.activation_f, self.conjugate_f
        gen_docs, std_docs, sub_mask, w = self._sub_docs(features, labels, mask, draws)

        def loss_of():
            lp_gen = log_ranking_prob_pl(d.forward(gen_docs, sub_mask), sub_mask)
            lp_std = log_ranking_prob_pl(d.forward(std_docs, sub_mask), sub_mask)
            return weighted_mean(conj(act(lp_gen)), w) - weighted_mean(act(lp_std), w)

        return d.update(loss_of)

    def _g_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: gen_unif [B, S, N]."""
        act, conj = self.activation_f, self.conjugate_f

        def loss_of():
            lp_g, d_sorted, sub_mask, w = self._g_log_probs(features, mask, draws)
            reward = conj(act(log_ranking_prob_pl(d_sorted, sub_mask)))
            return -weighted_mean(lp_g * reward, w)

        return self.generator.update(loss_of)
