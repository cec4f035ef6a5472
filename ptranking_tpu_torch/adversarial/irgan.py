"""IRGAN: minimax adversarial LTR (point / pair / list).

The port's copy of ptranking_tpu/adversarial/irgan.py (reference
ptranking/ltr_adversarial/{pointwise/irgan_point.py, pairwise/
irgan_pair.py, listwise/irgan_list.py}). Each G/D update is one batched
step over a padded bucket, eager on the device:

  * per-query "valid_num = min(num_pos, samples)" variable-size sampling
    becomes fixed `samples_per_query` draws WITH replacement plus a validity
    weight (num_pos >= 1);
  * torch.multinomial -> an inverse-CDF categorical over masked logits
    (util.categorical); randperm positive selection -> uniform index over
    the leading positives (training data is presorted, positives first);
  * the discriminator's double-sigmoid quirk is reproduced: D's scorer ends
    with a sigmoid (TL_AF='S', irgan_point.py:63) and its outputs are then
    fed to a BCE-with-logits objective (irgan_point.py:20,175).

Rewards and importance weights are detached where the JAX package takes
stop_gradient; the other player scores without a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ptranking_tpu_torch.adversarial.base import (AdversarialMachine, AdversarialPlayer, draw,
                                                  gather_docs, masked_mean, num_pos)
from ptranking_tpu_torch.adversarial.util import (
    gather_subrankings,
    generate_true_pairs,
    log_ranking_prob_bt,
    log_ranking_prob_pl,
    sample_categorical_masked,
    sample_pairs_bt,
    sample_pairs_gaussian,
    sample_pl_rankings,
    sample_uniform_positions,
    shuffled_truth_rankings,
    subranking_masks,
    weighted_mean,
)
from ptranking_tpu_torch.models.scorers import ScorerConfig
from ptranking_tpu_torch.ops import masked_softmax
from ptranking_tpu_torch.parallel.collectives import SINGLE
from ptranking_tpu_torch.train.optimizer import OptimizerConfig

LAMBDA = 0.5  # IRGAN Eq-22 mixture weight (irgan_point.py:17)


def make_players(sf_para, temperature: Optional[float] = None, seed: int = 137, device="cuda",
                 dp=SINGLE):
    """G keeps the configured scorer; D forces a sigmoid top layer
    (irgan_point.py:56-63). Both share the machine's data-parallel `dp`."""
    g_cfg: ScorerConfig = sf_para["scorer"]
    if not g_cfg.apply_tl_af:
        raise ValueError("IRGAN requires apply_tl_af=True (irgan_point.py:57)")
    d_cfg = dataclasses.replace(g_cfg, TL_AF="S")
    opt: OptimizerConfig = sf_para["optimizer"]
    g = AdversarialPlayer(g_cfg, opt_cfg=opt, temperature=temperature, seed=seed,
                          device=device)
    d = AdversarialPlayer(d_cfg, opt_cfg=opt, seed=seed + 1, device=device)
    g._dp = d._dp = dp
    return g.init(), d.init()


def init_minimax(machine: AdversarialMachine, sf_para, ad_para_dict, seed: int,
                 seed_offset: int, temperature: Optional[float]):
    """The settings every machine reads (temperature defaulting to
    `temperature`), both players, and the machine's generator seeded with
    seed + seed_offset (the JAX package's PRNGKey offsets)."""
    machine.temperature = ad_para_dict.get("temperature", temperature)
    machine.d_epoches = ad_para_dict.get("d_epoches", 1)
    machine.g_epoches = ad_para_dict.get("g_epoches", 1)
    machine.ad_training_order = ad_para_dict.get("ad_training_order", "DG")
    machine.samples_per_query = ad_para_dict.get("samples_per_query", 5)
    machine.generator, machine.discriminator = make_players(sf_para, machine.temperature, seed,
                                                            machine.device, machine._dp)
    machine._seed(seed + seed_offset)


def _rows(valid_q: torch.Tensor, width: int) -> torch.Tensor:
    """valid_q [B] broadcast to a [B, width] mask."""
    return valid_q[:, None].expand(valid_q.shape[0], width)


class IRGAN_Point(AdversarialMachine):
    """(reference irgan_point.py:48-232). D: BCE on generated pos/neg docs;
    G: REINFORCE with the Eq-22 importance-sampling mixture, reward (D-0.5)*2."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=7, temperature=0.5)

    def _d_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: pos_unif [B, S], neg_idx [B, S]."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S = self.samples_per_query
        npos = num_pos(labels, mask)
        valid_q = npos >= 1
        pos_idx = sample_uniform_positions(npos, S, N, self._gen, draw(draws, "pos_unif"))
        neg_idx = sample_categorical_masked(g.predict_scaled(features, mask), mask, S,
                                            gen=self._gen, idx=draw(draws, "neg_idx"))
        docs = torch.cat([gather_docs(features, pos_idx), gather_docs(features, neg_idx)], 1)
        targets = torch.cat([torch.ones(B, S, device=features.device),
                             torch.zeros(B, S, device=features.device)], 1)
        dmask = _rows(valid_q, 2 * S)

        def loss_of():
            preds = d.forward(docs, dmask)
            return masked_mean(F.softplus(preds) - targets * preds, dmask)  # BCEWithLogits

        return d.update(loss_of)

    def _g_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: choose_idx [B, 5S]."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        SG = 5 * self.samples_per_query
        npos = num_pos(labels, mask)
        valid_q = npos >= 1

        def loss_of():
            g_probs = masked_softmax(g.scaled(g.forward(features, mask)), mask)
            pos_positions = torch.arange(N, device=mask.device)[None] < npos[:, None]
            prob_is = g_probs * (1.0 - LAMBDA) + torch.where(
                pos_positions, LAMBDA / torch.clamp(npos[:, None], min=1), 0.0)
            prob_is = torch.where(mask, prob_is, 0.0)
            choose = sample_categorical_masked(
                torch.log(torch.clamp(prob_is, min=1e-20)), mask, SG, gen=self._gen,
                idx=draw(draws, "choose_idx"))
            gp = torch.gather(g_probs, 1, choose)
            pis = torch.gather(prob_is, 1, choose)
            is_w = (gp / torch.clamp(pis, min=1e-20)).detach()
            d_preds = d.predict_raw(gather_docs(features, choose), _rows(valid_q, SG))
            reward = (d_preds - 0.5) * 2.0
            terms = torch.log(torch.clamp(gp, min=1e-20)) * reward * is_w
            return -masked_mean(terms, _rows(valid_q, SG))

        return g.update(loss_of)


class IRGAN_Pair(AdversarialMachine):
    """(reference irgan_pair.py:50-236). Negatives drawn from the non-positive
    tail; D: hinge (svm) or log pairwise loss; G: REINFORCE with pairwise
    reward sigma(max(0, 1-(s+ - s-))) or log sigma(s- - s+)."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        self.loss_type = ad_para_dict.get("loss_type", "svm")
        # truth-side pair sampling scheme (reference pair_sampling.py:27-150):
        # uniform (reference IRGAN_Pair's randperm positives), discounted
        # (generate_true_pairs), BT (sample_pairs_BT on labels), Gaussian
        # (sample_pairs_gaussian on labels)
        self.truth_sampling = ad_para_dict.get("truth_sampling", "uniform")
        if self.truth_sampling not in ("uniform", "discounted", "BT", "Gaussian"):
            raise ValueError(f"truth_sampling {self.truth_sampling!r}")
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=11, temperature=0.5)

    def _truth_heads(self, labels, mask, draws):
        """Truth-side positive-doc indices per the configured scheme: the
        HEAD of a sampled true pair (reference pair_sampling.py samplers),
        and the queries that have one. Draws: truth_idx [B, S] (head * N +
        tail). The pair's negative leg always comes from the GENERATOR."""
        S = self.samples_per_query
        idx = draw(draws, "truth_idx")
        if self.truth_sampling == "discounted":
            head, _tail, has = generate_true_pairs(labels, mask, S, self._gen, idx)
            return head, has
        if self.truth_sampling == "BT":
            head, _tail = sample_pairs_bt(labels, mask, S, self._gen, idx=idx)
        else:  # Gaussian
            head, _tail = sample_pairs_gaussian(labels, mask, S, gen=self._gen, idx=idx)
        return head, num_pos(labels, mask) >= 1

    def _d_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: pos_unif [B, S] (uniform) or truth_idx [B, S] (the other
        schemes), neg_idx [B, S]."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S = self.samples_per_query
        npos = num_pos(labels, mask)
        if self.truth_sampling == "uniform":
            pos_idx = sample_uniform_positions(npos, S, N, self._gen, draw(draws, "pos_unif"))
            pos_ok = npos >= 1
        else:
            pos_idx, pos_ok = self._truth_heads(labels, mask, draws)
        neg_mask = mask & (torch.arange(N, device=mask.device)[None] >= npos[:, None])
        neg_idx = sample_categorical_masked(g.predict_scaled(features, mask), neg_mask, S,
                                            gen=self._gen, idx=draw(draws, "neg_idx"))
        valid_q = pos_ok & (torch.sum(mask, -1) - npos >= 1)
        pos_docs, neg_docs = gather_docs(features, pos_idx), gather_docs(features, neg_idx)
        smask = _rows(valid_q, S)

        def loss_of():
            sp, sn = d.forward(pos_docs, smask), d.forward(neg_docs, smask)
            if self.loss_type == "svm":
                l = torch.clamp(1.0 - (sp - sn), min=0.0)
            else:
                l = -F.logsigmoid(sp - sn)
            return masked_mean(l, smask)

        return d.update(loss_of)

    def _g_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        """Draws: pos_unif [B, S], neg_idx [B, S]."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S = self.samples_per_query
        npos = num_pos(labels, mask)
        smask = _rows(npos >= 1, S)
        pos_idx = sample_uniform_positions(npos, S, N, self._gen, draw(draws, "pos_unif"))
        dp = d.predict_raw(gather_docs(features, pos_idx), smask)

        def loss_of():
            g_probs = torch.sigmoid(g.scaled(g.forward(features, mask)))  # irgan_pair.py:224
            neg_idx = sample_categorical_masked(
                torch.log(torch.clamp(torch.where(mask, g_probs, 0.0), min=1e-20)), mask, S,
                gen=self._gen, idx=draw(draws, "neg_idx"))
            dn = d.predict_raw(gather_docs(features, neg_idx), smask)
            if self.loss_type == "svm":
                reward = torch.sigmoid(torch.clamp(1.0 - (dp - dn), min=0.0))
            else:
                reward = F.logsigmoid(dn - dp)
            gp = torch.gather(g_probs, 1, neg_idx)
            return -masked_mean(torch.log(torch.clamp(gp, min=1e-20)) * reward, smask)

        return g.update(loss_of)


class _ListSampling:
    """The sub-ranking draws IRGAN_List and IRFGAN_List share. The PL draw
    divides G's scaled scores by the temperature once more, as the JAX
    package does."""

    def _sub_docs(self, features, labels, mask, draws):
        """(generated and truth sub-ranking docs [B*S, k, F], sub_mask,
        row weights). Draws: gen_unif, std_unif [B, S, N]."""
        S, k = self.samples_per_query, self.top_k
        g_scores = self.generator.predict_scaled(features, mask)
        gen_order, _ = sample_pl_rankings(g_scores, mask, S, k, self.temperature, self._gen,
                                          draw(draws, "gen_unif"))
        std_order = shuffled_truth_rankings(labels, mask, S, k, self._gen,
                                            draw(draws, "std_unif"))
        # short lists cannot fill top-k, and all-padded remainder queries
        # of bucketed batches must not train D at all
        sub_mask, w = subranking_masks(mask, S, k)
        return (gather_subrankings(features, gen_order), gather_subrankings(features, std_order),
                sub_mask, w)

    def _g_log_probs(self, features, mask, draws):
        """(lp_g [B*S] with G's gradient, the D scores of the sampled
        sub-rankings [B*S, k], sub_mask, row weights). Draws: gen_unif."""
        g, d = self.generator, self.discriminator
        B, N, _ = features.shape
        S, k = self.samples_per_query, self.top_k
        d_scores_full = d.predict_raw(features, mask)
        order, top_probs = sample_pl_rankings(g.scaled(g.forward(features, mask)), mask, S, k,
                                              self.temperature, self._gen,
                                              draw(draws, "gen_unif"))
        sub_mask, w = subranking_masks(mask, S, k)
        lp_g = log_ranking_prob_pl(
            torch.log(torch.clamp(top_probs.reshape(B * S, k), min=1e-20)), sub_mask)
        d_sorted = torch.gather(d_scores_full[:, None, :].expand(B, S, N), -1,
                                order).reshape(B * S, k)
        return lp_g, d_sorted, sub_mask, w


class IRGAN_List(_ListSampling, AdversarialMachine):
    """(reference irgan_list.py:24-511). G samples rankings via Gumbel-softmax
    PL; D scores sampled top-k sub-rankings with PL/BT ranking log-probs;
    truth rankings come from per-sample tie shuffles of the (presorted)
    labels."""

    def __init__(self, sf_para=None, ad_para_dict=None, seed: int = 137, mesh=None,
                 device="cuda"):
        super().__init__(sf_para, ad_para_dict, mesh=mesh, device=device)
        self.top_k = ad_para_dict.get("top_k", 5)
        self.PL_discriminator = ad_para_dict.get("PL_D", True)
        # reference hard-codes False ("False is a must", irgan_list.py:127)
        self.replace_trick_4_discriminator = ad_para_dict.get("repTrick_D", False)
        self.replace_trick_4_generator = ad_para_dict.get("repTrick_G", False)
        self.drop_log = ad_para_dict.get("dropLog", True)  # reference default
        init_minimax(self, sf_para, ad_para_dict, seed, seed_offset=13, temperature=0.5)

    def _log_prob(self, preds, mask):
        return (log_ranking_prob_pl if self.PL_discriminator else log_ranking_prob_bt)(preds, mask)

    def _d_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        d = self.discriminator
        gen_docs, std_docs, sub_mask, w = self._sub_docs(features, labels, mask, draws)

        def loss_of():
            lp_gen = self._log_prob(d.forward(gen_docs, sub_mask), sub_mask)
            lp_std = self._log_prob(d.forward(std_docs, sub_mask), sub_mask)
            if self.replace_trick_4_discriminator:
                return weighted_mean(lp_gen - lp_std, w)
            # reference's "standard CE" (irgan_list.py:336-338), a faithful quirk
            return -(weighted_mean(lp_std, w)
                     + weighted_mean(torch.log(torch.clamp(1.0 - lp_gen, min=1e-20)), w))

        return d.update(loss_of)

    def _g_step(self, features, labels, mask, draws=None) -> torch.Tensor:
        def loss_of():
            lp_g, d_sorted, sub_mask, w = self._g_log_probs(features, mask, draws)
            lp_d = self._log_prob(d_sorted, sub_mask)
            if self.replace_trick_4_generator:
                reward = -torch.exp(lp_d) if self.drop_log else -lp_d
            else:
                reward = (torch.exp(1.0 - lp_d) if self.drop_log
                          else torch.log(torch.clamp(1.0 - lp_d, min=1e-20)))
            return weighted_mean(lp_g * reward, w)

        return self.generator.update(loss_of)
