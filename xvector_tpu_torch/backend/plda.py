"""Scoring back end: mean/LDA/length-norm/PLDA train-adapt-score.

Native replacement for the Kaldi C++ ``ivector-*`` binaries the reference
pipes through in ``run.sh:250-313`` (K10–K18 in SURVEY §2.2):

* :func:`global_mean` / centering             — ivector-{mean,subtract-global-mean}
* :func:`train_lda` / :meth:`Lda.transform`   — ivector-compute-lda
  (``--dim=100 --total-covariance-factor=0.0``, run.sh:256-261)
* :func:`length_normalize`                    — ivector-normalize-length
  (scale to ‖v‖ = √dim)
* :class:`Plda` (two-covariance EM trainer,
  unsupervised covariance adaptation, trial LLR
  scoring with multi-enroll posteriors)        — ivector-compute-plda /
  ivector-adapt-plda (within .75 / between .25, run.sh:272-276) /
  ivector-plda-scoring --num-utts (run.sh:281-287)

All math is small dense linear algebra over (dim ≤ a few hundred) matrices;
it runs on host numpy/scipy in float64 for conditioning.  Trial scoring is
vectorised over the whole trial list at once.  Own copy of
``xvector_tpu/backend/plda.py``: a :class:`Plda` saved by either package
(``np.savez``) loads in the other.  The card's counterparts of the EM and
the scoring are in :mod:`.plda_device`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import scipy.linalg

__all__ = ["global_mean", "length_normalize", "Lda", "train_lda",
           "Plda", "train_plda"]


def global_mean(vectors: Iterable[np.ndarray]) -> np.ndarray:
    vs = np.stack(list(vectors)).astype(np.float64)
    return vs.mean(0)


def length_normalize(v: np.ndarray) -> np.ndarray:
    """Scale each row to norm √dim (Kaldi ivector-normalize-length)."""
    v = np.asarray(v, np.float64)
    single = v.ndim == 1
    if single:
        v = v[None]
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    out = v * (np.sqrt(v.shape[1]) / np.maximum(norms, 1e-20))
    return out[0] if single else out


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

@dataclass
class Lda:
    transform: np.ndarray          # (out_dim, in_dim)
    mean: np.ndarray               # (in_dim,)

    def __call__(self, v: np.ndarray) -> np.ndarray:
        return (np.asarray(v, np.float64) - self.mean) @ self.transform.T


def train_lda(spk2vecs: Dict[str, np.ndarray], dim: int,
              total_covariance_factor: float = 0.0) -> Lda:
    """LDA maximising between/within variance ratio.

    spk2vecs: speaker → (n_i, D) stacked vectors.
    ``total_covariance_factor`` interpolates the denominator covariance
    between within-class (0.0, the recipe's setting) and total covariance.
    """
    all_v = np.concatenate([np.asarray(v, np.float64)
                            for v in spk2vecs.values()])
    mean = all_v.mean(0)
    d = all_v.shape[1]
    sw = np.zeros((d, d))
    sb = np.zeros((d, d))
    n_tot = 0
    for v in spk2vecs.values():
        v = np.asarray(v, np.float64)
        mu = v.mean(0)
        c = v - mu
        sw += c.T @ c
        diff = (mu - mean)[:, None]
        sb += len(v) * (diff @ diff.T)
        n_tot += len(v)
    sw /= n_tot
    sb /= n_tot
    st = sw + sb
    denom = ((1.0 - total_covariance_factor) * sw
             + total_covariance_factor * st)
    denom += 1e-6 * np.trace(denom) / d * np.eye(d)
    evals, evecs = scipy.linalg.eigh(sb, denom)
    order = np.argsort(evals)[::-1][:dim]
    w = evecs[:, order].T                      # rows are directions
    # normalise rows so projected within-class covariance is identity-ish
    return Lda(transform=w, mean=mean)


# ---------------------------------------------------------------------------
# PLDA (two-covariance model)
# ---------------------------------------------------------------------------

@dataclass
class Plda:
    """Two-covariance PLDA stored in Kaldi's diagonalised form: transform T
    maps a centered vector into a space where the within-class covariance is
    identity and the between-class covariance is diag(psi)."""

    mean: np.ndarray          # (D,)
    transform: np.ndarray     # (D, D)
    psi: np.ndarray           # (D,) between-class variances

    # -- projection -------------------------------------------------------
    def project(self, v: np.ndarray,
                simple_length_norm: bool = False,
                num_examples: int = 1) -> np.ndarray:
        """Kaldi Plda::TransformIvector with normalize_length=true: apply
        the diagonalising transform then rescale so the expected squared
        norm matches its model value (plda.cc GetNormalizationFactor).

        ``num_examples``: when ``v`` is the AVERAGE of n enrollment
        utterances, its model covariance is ``diag(psi) + I/n`` — the
        ``--num-utts`` normalisation of ``ivector-plda-scoring``
        (run.sh:281-287)."""
        v = np.asarray(v, np.float64)
        single = v.ndim == 1
        if single:
            v = v[None]
        u = (v - self.mean) @ self.transform.T
        d = u.shape[1]
        if simple_length_norm:
            factor = np.sqrt(d) / np.linalg.norm(u, axis=1)
        else:
            inv_covar = 1.0 / (1.0 / num_examples + self.psi)
            factor = np.sqrt(d / np.einsum("nd,d,nd->n", u, inv_covar, u))
        u = u * factor[:, None]
        return u[0] if single else u

    # -- scoring ----------------------------------------------------------
    def llr(self, enroll: np.ndarray, test: np.ndarray,
            n_enroll: np.ndarray | int = 1) -> np.ndarray:
        """Vectorised trial log-likelihood ratios.

        enroll: (N, D) projected enrollment vectors (averages of n utts),
        test: (N, D) projected test vectors, n_enroll: per-trial counts.
        Kaldi Plda::LogLikelihoodRatio: same-speaker hypothesis models the
        test vector as N(nψ/(nψ+1)·ū, I + ψ/(nψ+1)); different-speaker as
        N(0, I + ψ).
        """
        enroll = np.atleast_2d(np.asarray(enroll, np.float64))
        test = np.atleast_2d(np.asarray(test, np.float64))
        n = np.broadcast_to(np.asarray(n_enroll, np.float64),
                            (enroll.shape[0],))[:, None]
        psi = self.psi[None, :]
        m_same = (n * psi / (n * psi + 1.0)) * enroll
        v_same = 1.0 + psi / (n * psi + 1.0)
        v_diff = 1.0 + psi

        def loglike(x, mu, var):
            return -0.5 * np.sum(np.log(2.0 * np.pi * var)
                                 + (x - mu) ** 2 / var, axis=1)

        return loglike(test, m_same, v_same) \
            - loglike(test, 0.0, v_diff)

    def score_trials(self, enroll_vecs: Dict[str, np.ndarray],
                     test_vecs: Dict[str, np.ndarray],
                     trials: Sequence[Tuple[str, str]],
                     num_utts: Optional[Dict[str, int]] = None
                     ) -> np.ndarray:
        """Score (enroll_id, test_id) trials; vectors are raw (unprojected)
        x-vectors — projection happens here.  ``num_utts`` drives BOTH the
        projection normalisation (diag(psi)+I/n covariance of an n-average)
        and the same-speaker hypothesis in the LLR, exactly as
        ``ivector-plda-scoring --num-utts=...`` (run.sh:281-287)."""
        e_keys = list(enroll_vecs)
        t_keys = list(test_vecs)
        e_proj = {}
        by_n: Dict[int, list] = {}
        for k in e_keys:
            by_n.setdefault(int((num_utts or {}).get(k, 1)), []).append(k)
        for n, keys in by_n.items():
            proj = self.project(np.stack([enroll_vecs[k] for k in keys]),
                                num_examples=n)
            e_proj.update(zip(keys, proj))
        t_proj = {k: v for k, v in zip(
            t_keys, self.project(np.stack([test_vecs[k]
                                           for k in t_keys])))}
        e = np.stack([e_proj[a] for a, _ in trials])
        t = np.stack([t_proj[b] for _, b in trials])
        n = np.array([(num_utts or {}).get(a, 1) for a, _ in trials])
        return self.llr(e, t, n)

    # -- unsupervised adaptation -----------------------------------------
    def adapt(self, vectors: np.ndarray, within_covar_scale: float = 0.75,
              between_covar_scale: float = 0.25) -> "Plda":
        """Kaldi PldaUnsupervisedAdaptor semantics (run.sh:272-276): where
        the in-domain total covariance exceeds the model's, distribute the
        excess variance into the within/between covariances with the given
        scales, then re-diagonalise."""
        x = np.asarray(vectors, np.float64)
        u = (x - x.mean(0)) @ self.transform.T   # model's diag space
        tot = np.cov(u.T, bias=True)
        evals, evecs = np.linalg.eigh(tot)
        w_new = np.eye(len(self.psi))
        b_new = np.diag(self.psi.copy())
        for lam, vec in zip(evals, evecs.T):
            model_var = np.sum(vec * (1.0 + self.psi) * vec)
            excess = max(0.0, lam - model_var)
            if excess > 0:
                outer = np.outer(vec, vec)
                w_new += within_covar_scale * excess * outer
                b_new += between_covar_scale * excess * outer
        # re-diagonalise the adapted covariances in the original space
        inv_t = np.linalg.inv(self.transform)
        w_orig = inv_t @ w_new @ inv_t.T
        b_orig = inv_t @ b_new @ inv_t.T
        return _from_covariances(self.mean, b_orig, w_orig)

    # -- persistence ------------------------------------------------------
    def save(self, path: str):
        np.savez(path, mean=self.mean, transform=self.transform,
                 psi=self.psi)

    @staticmethod
    def load(path: str) -> "Plda":
        z = np.load(path)
        return Plda(z["mean"], z["transform"], z["psi"])


def _from_covariances(mean: np.ndarray, between: np.ndarray,
                      within: np.ndarray) -> Plda:
    """Build the diagonalised form: T with T W Tᵀ = I and
    T B Tᵀ = diag(psi)  (Kaldi PldaEstimator::GetOutput)."""
    d = len(mean)
    within = within + 1e-8 * np.trace(within) / d * np.eye(d)
    # whiten within: W = L Lᵀ, T1 = L⁻¹
    l = np.linalg.cholesky(within)
    t1 = np.linalg.inv(l)
    b_w = t1 @ between @ t1.T
    evals, evecs = np.linalg.eigh(b_w)
    order = np.argsort(evals)[::-1]
    psi = np.maximum(evals[order], 1e-10)
    transform = evecs[:, order].T @ t1
    return Plda(mean=np.asarray(mean, np.float64), transform=transform,
                psi=psi)


def train_plda(spk2vecs: Dict[str, np.ndarray], num_em_iters: int = 10
               ) -> Plda:
    """Two-covariance PLDA via EM on speaker-grouped vectors
    (ivector-compute-plda equivalent; Kaldi PldaEstimator runs 10 EM
    iterations by default)."""
    groups = [np.asarray(v, np.float64) for v in spk2vecs.values()
              if len(v) >= 1]
    all_v = np.concatenate(groups)
    mean = all_v.mean(0)
    groups = [g - mean for g in groups]
    d = all_v.shape[1]
    n_spk = len(groups)
    n_tot = sum(len(g) for g in groups)

    # init: split total covariance evenly.  The ridge keeps EM stable when
    # n_utts < dim (the recipe avoids this via LDA to dim 100, run.sh:256,
    # but the trainer must not blow up without it).
    tot = sum(g.T @ g for g in groups) / n_tot
    ridge = 1e-4 * np.trace(tot) / d + 1e-8
    b = tot / 2 + ridge * np.eye(d)
    w = tot / 2 + ridge * np.eye(d)

    counts = sorted({len(g) for g in groups})
    sums = {id(g): g.sum(0) for g in groups}
    for _ in range(num_em_iters):
        w_inv = np.linalg.inv(w)
        b_inv = np.linalg.inv(b)
        # cache per-count posterior covariance
        post_cov = {n: np.linalg.inv(b_inv + n * w_inv) for n in counts}
        b_acc = np.zeros((d, d))
        w_acc = np.zeros((d, d))
        for g in groups:
            n = len(g)
            cov = post_cov[n]
            y_hat = cov @ (w_inv @ sums[id(g)])
            b_acc += cov + np.outer(y_hat, y_hat)
            r = g - y_hat
            w_acc += r.T @ r + n * cov
        b = b_acc / n_spk + ridge * np.eye(d)
        w = w_acc / n_tot + ridge * np.eye(d)

    return _from_covariances(mean, b, w)
