"""The recipe's back-end stages: PLDA training, adaptation, scoring.

Counterpart of ``xvector_tpu/cli/run.py`` (the reference's ``run.sh``
stages 8-10, ``run.sh:250-313``).  The port's :class:`Recipe` holds the
back-end stages only: :meth:`Recipe.score` (mean or LDA, length-norm,
PLDA, optional adaptation, trial scoring, EER/minDCF) and
:meth:`Recipe.score_sre16` (the full SRE16 protocol).  The front-end,
egs, training and extraction stages, and the :class:`RecipeConfig`
fields they read, come with the rest of the recipe (ROADMAP A10b).

At 2,000 training speakers or more, the PLDA EM runs on the device
(:func:`~xvector_tpu_torch.backend.plda_device.train_plda_device`, on
``RecipeConfig.device``); below that the float64 host EM wins.  Trial
scoring is the host's float64 :meth:`Plda.score_trials`, as upstream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..backend import metrics as metricslib
from ..backend import plda as pldalib
from ..backend.plda_device import train_plda_device
from ..io.datadir import DataDir

__all__ = ["RecipeConfig", "Recipe"]

# the device EM's batched sufficient-statistic formulation stays flat as the
# speaker count grows; the f64 host loop wins on small sets
DEVICE_EM_MIN_SPEAKERS = 2000


@dataclass(frozen=True)
class RecipeConfig:
    work_dir: str
    lda_dim: int = 0                  # 0 = skip LDA in score (run.sh: 100)
    plda_em_iters: int = 10
    device: str = "cuda"              # where the EM runs at >= 2,000 spk


class Recipe:
    def __init__(self, cfg: RecipeConfig):
        resolve_device(cfg.device)    # no card: raise unless "cpu"
        self.cfg = cfg
        os.makedirs(cfg.work_dir, exist_ok=True)

    def _train_plda(self, grouped: Dict[str, np.ndarray]) -> pldalib.Plda:
        if len(grouped) >= DEVICE_EM_MIN_SPEAKERS:
            return train_plda_device(grouped,
                                     num_em_iters=self.cfg.plda_em_iters,
                                     device=self.cfg.device)
        return pldalib.train_plda(grouped,
                                  num_em_iters=self.cfg.plda_em_iters)

    # -- stage 5: backend (run.sh:250-313) ---------------------------------
    def score(self, train_xv: Dict[str, np.ndarray], train_dir: DataDir,
              enroll_xv: Dict[str, np.ndarray],
              test_xv: Dict[str, np.ndarray],
              trials: Iterable[Tuple[str, str, int]],
              adapt_xv: Optional[Dict[str, np.ndarray]] = None,
              num_utts: Optional[Dict[str, int]] = None
              ) -> Dict[str, float]:
        """Train (and optionally adapt) the PLDA on training x-vectors,
        score (enroll, test, label) trials, return metrics.  ``num_utts``
        applies the multi-enroll LLR normalisation (run.sh:281-287)."""
        cfg = self.cfg
        mean = pldalib.global_mean(train_xv.values())

        lda = None
        if cfg.lda_dim > 0:
            spk_groups: Dict[str, list] = {}
            for u, v in train_xv.items():
                spk_groups.setdefault(train_dir.utt2spk[u], []).append(
                    np.asarray(v, np.float64))
            lda = pldalib.train_lda(
                {s: np.stack(vs) for s, vs in spk_groups.items()},
                dim=cfg.lda_dim)

        def prep(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            """center → (LDA) → length-norm, the run.sh:279-287 chain."""
            if lda is not None:
                arr = {k: lda(np.asarray(v, np.float64))
                       for k, v in vecs.items()}   # Lda centers internally
            else:
                arr = {k: np.asarray(v, np.float64) - mean
                       for k, v in vecs.items()}
            return {k: pldalib.length_normalize(v) for k, v in arr.items()}

        train_p = prep(train_xv)
        spk2vecs: Dict[str, list] = {}
        for u, v in train_p.items():
            spk2vecs.setdefault(train_dir.utt2spk[u], []).append(v)
        grouped = {s: np.stack(vs) for s, vs in spk2vecs.items()}
        model = self._train_plda(grouped)
        if adapt_xv:
            model = model.adapt(np.stack(list(prep(adapt_xv).values())))

        trials = list(trials)
        pairs = [(e, t) for e, t, _ in trials]
        labels = np.array([l for _, _, l in trials])
        llr = model.score_trials(prep(enroll_xv), prep(test_xv), pairs,
                                 num_utts=num_utts)
        return {"eer": metricslib.eer(llr, labels),
                "min_dcf": metricslib.min_dcf(llr, labels),
                "num_trials": len(trials),
                "scores": llr}

    # -- stage 5b: the full SRE16 back-end protocol (run.sh:250-313) -------
    def score_sre16(self, train_xv: Dict[str, np.ndarray],
                    train_dir: DataDir,
                    unlabeled_xv: Dict[str, np.ndarray],
                    enroll_xv: Dict[str, np.ndarray],
                    test_xv: Dict[str, np.ndarray],
                    trials: Iterable[Tuple[str, str, int]],
                    num_utts: Optional[Dict[str, int]] = None,
                    utt2cond: Optional[Dict[str, str]] = None,
                    lda_dim: int = 100) -> Dict[str, Dict]:
        """Orchestrates the reference's stages 8-10 end to end:

        * global mean from the UNLABELED in-domain majors (run.sh:252-254)
          — the eval-side centering uses this mean, while LDA/PLDA train
          on the labeled set centered on its OWN mean (the dual-mean
          protocol of run.sh:256-267 vs :279-287);
        * LDA to ``lda_dim`` (100) on the labeled set (run.sh:256-261);
        * PLDA on LDA'd + length-normalised labeled vectors (run.sh:263-267);
        * unsupervised PLDA adaptation on the majors (run.sh:269-276);
        * BOTH out-of-domain and adapted scoring with ``--num-utts``
          multi-enroll normalisation (run.sh:279-287, :297-305);
        * pooled + per-condition EER/minDCF (the per-language splits of
          run.sh:289-294, :309-312) via ``utt2cond`` on test segments.

        Returns ``{"out_of_domain": res, "adapted": res}`` where each res
        holds pooled metrics, ``scores`` (per-trial LLRs), and
        ``per_condition`` metrics when ``utt2cond`` is given.
        """
        trials = list(trials)
        pairs = [(e, t) for e, t, _ in trials]
        labels = np.array([l for _, _, l in trials])

        major_mean = pldalib.global_mean(unlabeled_xv.values())

        spk_groups: Dict[str, list] = {}
        for u, v in train_xv.items():
            spk_groups.setdefault(train_dir.utt2spk[u], []).append(
                np.asarray(v, np.float64))
        lda = pldalib.train_lda(
            {s: np.stack(vs) for s, vs in spk_groups.items()}, dim=lda_dim)

        # PLDA training chain: own-mean center (inside Lda) → LDA →
        # length-norm (run.sh:263-267)
        grouped = {s: np.stack([pldalib.length_normalize(lda(v))
                                for v in vs])
                   for s, vs in spk_groups.items()}
        model = self._train_plda(grouped)

        # eval chain: majors mean → LDA transform → length-norm
        # (run.sh:279-287; note transform-vec applies the LDA matrix to
        # the mean-subtracted vector, not Lda's own centering)
        def prep_eval(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            return {k: pldalib.length_normalize(
                (np.asarray(v, np.float64) - major_mean) @ lda.transform.T)
                for k, v in vecs.items()}

        enroll_p = prep_eval(enroll_xv)
        test_p = prep_eval(test_xv)
        adapted = model.adapt(
            np.stack(list(prep_eval(unlabeled_xv).values())))

        def evaluate(m) -> Dict:
            llr = m.score_trials(enroll_p, test_p, pairs,
                                 num_utts=num_utts)
            res = {"eer": metricslib.eer(llr, labels),
                   "min_dcf": metricslib.min_dcf(llr, labels),
                   "num_trials": len(trials),
                   "scores": llr}
            if utt2cond:
                per = {}
                for cond in sorted(set(utt2cond.values())):
                    idx = [i for i, (_, t, _) in enumerate(trials)
                           if utt2cond.get(t) == cond]
                    if idx:
                        per[cond] = {
                            "eer": metricslib.eer(llr[idx], labels[idx]),
                            "min_dcf": metricslib.min_dcf(llr[idx],
                                                          labels[idx]),
                            "num_trials": len(idx)}
                res["per_condition"] = per
            return res

        return {"out_of_domain": evaluate(model),
                "adapted": evaluate(adapted)}
