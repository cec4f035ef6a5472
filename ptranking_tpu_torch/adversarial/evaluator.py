"""AdLTREvaluator: the adversarial k-fold runner with the full config system.

The port's copy of ptranking_tpu/adversarial/evaluator.py (reference
AdLTREvaluator, ltr_adversarial/eval/ltr_adversarial.py:31-393): burn-in
(10 epochs, 2 in debug; the machines' burn_in is a no-op, as in the JAX
package), per-epoch minimax training with the generator stop guard
(:129-146, once an epoch), separate G/D validation tapes with their best
`.pt` checkpoints and summary tapes (:147-165), the final fold test of both
players (:211-215), and the three-source config stack (grid_run /
point_run / run, :326-393). On one device (`device="cuda"` unless the
caller asks for the CPU), or with a `mesh` eval setting both players
data-parallel over the process group's ranks, as in the JAX package (only
rank 0 writes files; `tp`, `shard_docs` and `pp_stages` are not read by
this branch). The training data is device-resident by default
(the adhoc evaluator's load_data), each epoch's index chunks copied once and
walked by the D and the G pass.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ptranking_tpu_torch.adversarial.irfgan import IRFGAN_List, IRFGAN_Pair, IRFGAN_Point
from ptranking_tpu_torch.adversarial.irgan import IRGAN_List, IRGAN_Pair, IRGAN_Point
from ptranking_tpu_torch.adversarial.settings import (AdDataSetting, AdEvalSetting,
                                                      AdModelSetting, AdSFSetting)
from ptranking_tpu_torch.eval.evaluator import LTREvaluator
from ptranking_tpu_torch.eval.tapes import SummaryTape, ValidationTape
from ptranking_tpu_torch.parallel.collectives import is_writer
from ptranking_tpu_torch.utils.runlog import run_log

LTR_ADVERSARIAL_MODELS = ["IRGAN_Point", "IRGAN_Pair", "IRGAN_List",
                          "IRFGAN_Point", "IRFGAN_Pair", "IRFGAN_List"]

AD_MACHINES = {
    "IRGAN_Point": IRGAN_Point, "IRGAN_Pair": IRGAN_Pair, "IRGAN_List": IRGAN_List,
    "IRFGAN_Point": IRFGAN_Point, "IRFGAN_Pair": IRFGAN_Pair, "IRFGAN_List": IRFGAN_List,
}


class AdLTREvaluator(LTREvaluator):
    """Inherits load_data/determine_files from the adhoc evaluator (the
    reference's AdLTREvaluator subclasses LTREvaluator the same way)."""

    def get_ad_machine(self, model_id: str, sf_para, ad_para_dict, seed: int = 137, mesh=None):
        """(reference get_ad_machine, ltr_adversarial.py:62-78) on the
        evaluator's device; with a mesh (a DeviceMesh or an axis-size dict)
        both players are data-parallel."""
        return AD_MACHINES[model_id](sf_para=sf_para, ad_para_dict=ad_para_dict, seed=seed,
                                     mesh=mesh, device=self.device)

    # --------------------------------------------------------------- output

    def setup_output(self, data_dict, eval_dict) -> str:
        """The run directory, named as the JAX package names it."""
        model_id = self.model_setting.model_id
        dir_output = eval_dict["dir_output"]
        dir_root = (os.path.join(dir_output, f"gpu_grid_{model_id}")
                    if eval_dict.get("grid_search") else dir_output)
        prefix = "_".join([model_id, "SF", self.sf_setting.to_para_string(),
                           self.data_setting.to_data_setting_string(),
                           self.eval_setting.to_eval_setting_string()])
        dir_run = os.path.join(dir_root, prefix, self.model_setting.to_para_string())
        if is_writer():
            os.makedirs(dir_run, exist_ok=True)
        return dir_run

    # ------------------------------------------------------------- training

    def ad_cv_eval(self, data_dict, eval_dict, sf_para, ad_para_dict) -> Dict[str, Any]:
        """The minimax CV loop (reference ad_cv_eval, ltr_adversarial.py:80-246)
        over settings dicts; the run's output is teed to a log file in the
        run directory unless do_log is off or in debug mode."""
        with run_log(self.setup_output(data_dict, eval_dict),
                     enabled=eval_dict.get("do_log", True),
                     debug=eval_dict.get("debug", False)):
            return self._ad_cv_eval(data_dict, eval_dict, sf_para, ad_para_dict)

    def _ad_cv_eval(self, data_dict, eval_dict, sf_para, ad_para_dict) -> Dict[str, Any]:
        model_id = ad_para_dict["model_id"]
        if model_id not in LTR_ADVERSARIAL_MODELS:
            raise ValueError(f"{model_id!r} not in {LTR_ADVERSARIAL_MODELS}")
        fold_num = data_dict["fold_num"]
        epochs = eval_dict["epochs"]
        do_vali = eval_dict["do_validation"]
        do_summary = eval_dict.get("do_summary", False)
        vali_k = eval_dict.get("vali_k") or 5
        log_step = eval_dict.get("log_step", 1)
        cutoffs = tuple(eval_dict["cutoffs"])
        dir_run = self.setup_output(data_dict, eval_dict)
        paras = {k: v for k, v in ad_para_dict.items() if k != "model_id"}

        results = {"G": [], "D": []}
        for fold_k in range(1, fold_num + 1):
            machine = self.get_ad_machine(model_id, sf_para, paras, seed=137 + fold_k,
                                          mesh=eval_dict.get("mesh"))
            train_ds, test_ds, vali_ds = self.load_data(eval_dict, data_dict, fold_k)
            machine.fill_global_buffer(train_ds)
            # burn-in (reference ltr_adversarial.py:126-127: 10 epochs)
            for _ in range(2 if eval_dict.get("debug") else 10):
                machine.burn_in(train_data=train_ds)

            g_tape = ValidationTape(fold_k, epochs, "nDCG", vali_k, os.path.join(dir_run, "G"))
            d_tape = ValidationTape(fold_k, epochs, "nDCG", vali_k, os.path.join(dir_run, "D"))
            tapes = {}
            if do_summary:
                tapes = {n: SummaryTape(do_vali, dir_run, fold_k, cutoffs=cutoffs, id_str=n)
                         for n in ("G", "D")}
            guard_batch = next(iter(train_ds.batches()))
            for epoch_k in range(1, epochs + 1):
                stop = machine.mini_max_train(train_data=train_ds, epoch_k=epoch_k, shuffle=True)
                # per-epoch generator stop guard (reference checks the G
                # ranker's predictions every epoch, ltr_adversarial.py:129-146)
                stop = stop or machine.get_generator().stop_training(guard_batch)
                if stop:
                    print("training is failed !")
                    break
                if (do_vali or do_summary) and (epoch_k % log_step == 0 or epoch_k == 1):
                    for name, player, tape in (("G", machine.get_generator(), g_tape),
                                               ("D", machine.get_discriminator(), d_tape)):
                        v = player.validation(vali_ds, k=vali_k) if do_vali else None
                        if do_vali:
                            tape.epoch_validation(epoch_k, v, player)
                        if do_summary:
                            tapes[name].epoch_summary(
                                0.0, v, ranker=player, train_data=train_ds, test_data=test_ds)

            for name, player, tape in (("G", machine.get_generator(), g_tape),
                                       ("D", machine.get_discriminator(), d_tape)):
                if do_vali and player._dp.from_first(os.path.exists, tape.get_optimal_path()):
                    player.load(tape.get_optimal_path())
                tape.clear_fold_buffer()
                if do_summary:
                    tapes[name].fold_summary(train_data_length=train_ds.num_queries)
                m = player.evaluate(test_ds, ks=cutoffs)
                results[name].append(m["nDCG"])
                print(f" Fold-{fold_k} {model_id} {name} test nDCG: "
                      + ", ".join(f"@{k}:{v:.4f}" for k, v in zip(cutoffs, m["nDCG"])))

        cv = {name: np.mean(np.stack(v), axis=0) for name, v in results.items()}
        print(f"\n{model_id} {fold_num}-fold CV: "
              + " | ".join(f"{n} nDCG@5: {cv[n][min(2, len(cutoffs) - 1)]:.4f}"
                           for n in ("G", "D")))
        return cv

    # ------------------------------------------------------------ dispatch

    def set_settings(self, debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json):
        if dir_json:
            ad_json = os.path.join(dir_json, "Ad_Data_Eval_ScoringFunction.json")
            para_json = os.path.join(dir_json, f"{model_id}Parameter.json")
            self.data_setting = AdDataSetting(debug, data_json=ad_json)
            self.eval_setting = AdEvalSetting(debug, eval_json=ad_json,
                                              overrides=self.mesh_overrides)
            self.sf_setting = AdSFSetting(debug, sf_id=sf_id, sf_json=ad_json)
            self.model_setting = AdModelSetting(model_id, debug, para_json=para_json)
        else:
            self.data_setting = AdDataSetting(debug, data_id=data_id, dir_data=dir_data)
            self.eval_setting = AdEvalSetting(debug, dir_output=dir_output,
                                              overrides=self.mesh_overrides)
            self.sf_setting = AdSFSetting(debug, sf_id=sf_id)
            self.model_setting = AdModelSetting(model_id, debug)

    def point_run(self, debug=False, model_id=None, sf_id="pointsf", data_id=None,
                  dir_data=None, dir_output="./output", dir_json=None,
                  epochs: Optional[int] = None, model_paras: Optional[dict] = None):
        """Single-setting run (reference point_run, ltr_adversarial.py:353-376).
        `epochs`/`model_paras` are direct overrides for programmatic use."""
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        data_dict = self.data_setting.default_setting()
        eval_dict = self.eval_setting.default_setting()
        if epochs is not None:
            eval_dict["epochs"] = epochs
        sf_para = self.sf_setting.default_setting(data_dict["num_features"])
        ad_para = {"model_id": model_id, **self.model_setting.default_para_dict(),
                   **(model_paras or {})}
        self.model_setting.para_dict.update(model_paras or {})
        return self.ad_cv_eval(data_dict, eval_dict, sf_para, ad_para)

    def grid_run(self, debug=False, model_id=None, sf_id="pointsf", data_id=None,
                 dir_data=None, dir_output="./output", dir_json=None):
        """Grid search (reference grid_run, ltr_adversarial.py:326-350).
        Best = generator nDCG@vali_k."""
        self.set_settings(debug, model_id, sf_id, data_id, dir_data, dir_output, dir_json)
        best_value, best_cv = -np.inf, None
        for data_dict in self.data_setting.grid_search():
            for eval_dict in self.eval_setting.grid_search():
                for sf_para in self.sf_setting.grid_search(data_dict["num_features"]):
                    for ad_para in self.model_setting.grid_search():
                        mp = {"model_id": model_id, **ad_para}
                        cv = self.ad_cv_eval(data_dict, eval_dict, sf_para, mp)
                        vk = eval_dict.get("vali_k") or 5
                        k_idx = eval_dict["cutoffs"].index(vk) if vk in eval_dict["cutoffs"] else 0
                        val = float(cv["G"][k_idx])
                        if val > best_value:
                            best_value, best_cv = val, cv
        return best_cv

    def run(self, debug=False, model_id=None, sf_id="pointsf", config_with_json=False,
            dir_json=None, data_id=None, dir_data=None, dir_output="./output",
            grid_search=False):
        """Entry point (reference run, ltr_adversarial.py:378-393): json mode
        always grid."""
        if model_id not in LTR_ADVERSARIAL_MODELS:
            raise ValueError(f"{model_id!r} not in {LTR_ADVERSARIAL_MODELS}")
        if config_with_json:
            if dir_json is None:
                raise ValueError("config_with_json needs dir_json")
            return self.grid_run(debug, model_id, sf_id, dir_json=dir_json)
        if grid_search:
            return self.grid_run(debug, model_id, sf_id, data_id, dir_data, dir_output)
        return self.point_run(debug, model_id, sf_id, data_id, dir_data, dir_output)
