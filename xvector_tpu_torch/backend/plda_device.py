"""PLDA trial scoring and two-covariance EM on the card.

Counterpart of ``xvector_tpu/backend/plda_device.py``.  The host
:mod:`.plda` module keeps Kaldi's ``ivector-plda-scoring`` semantics in
float64; this module scores whole trial lists on the device: the per-trial
log-likelihood ratio

    llr(e, t) = logN(t; nψ/(nψ+1)·ē, I + ψ/(nψ+1)) − logN(t; 0, I + ψ)

(reference protocol ``run.sh:279-287``, Kaldi ``Plda::LogLikelihoodRatio``)
decomposes, for the full enroll×test score matrix, into

    S[i, j] = −½·(  Σ_d log v_i,d               (enroll row term)
                  + Σ_d m_i,d² / v_i,d          (enroll row term)
                  + Σ_d t_j,d² · (1/v_i,d)      ← matmul  t² · (1/v)ᵀ
                  − 2 Σ_d t_j,d · (m_i,d/v_i,d) ← matmul  t · (m/v)ᵀ
                 ) − loglike_diff[j]            (test column term)

i.e. two (P, D)×(D, M) matrix products plus rank-1 row and column terms.

Precision: the LLR is a difference of large quadratic terms, so every
float32 product here runs in full f32.  Each public function sets
``torch.set_float32_matmul_precision("highest")`` (TF32 off) for its
duration and restores the caller's setting afterwards, so the numbers do
not depend on what the caller allowed.  The EM's sufficient statistics
(``_em_stats``), its initialisation and ridge, and the final
diagonalisation (``plda._from_covariances``) stay host numpy in float64,
as upstream; only the EM iterations and the scoring run on the device in
float32.

Every public function takes ``device=`` (default ``"cuda"``, which raises
without a card; pass ``"cpu"`` to run on the CPU).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .plda import Plda, _from_covariances

__all__ = ["project_device", "score_matrix", "score_trials_device",
           "train_plda_device"]

_LOG_2PI = float(np.log(2.0 * np.pi))


@contextlib.contextmanager
def _full_f32():
    """TF32 off for float32 products inside; the caller's setting after."""
    allow = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        # in torch the two flags may be one setting: the precision last
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.set_float32_matmul_precision(precision)


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


@_full_f32()
def project_device(plda: Plda, v, simple_length_norm: bool = False,
                   num_examples=1, device="cuda") -> torch.Tensor:
    """Device version of :meth:`Plda.project` (transform to the
    diagonalised space + Kaldi length normalisation).  ``num_examples``
    (scalar or (N,)) is the count behind each averaged vector — its model
    covariance is ``diag(psi) + I/n`` (plda.cc GetNormalizationFactor
    with the --num-utts path).  Returns an (N, D) float32 tensor on
    ``device``."""
    dev = resolve_device(device)
    v = _f32(v, dev)
    u = (v - _f32(plda.mean, dev)) @ _f32(plda.transform, dev).T
    d = u.shape[1]
    if simple_length_norm:
        factor = float(np.sqrt(d)) / torch.linalg.norm(u, dim=1)
    else:
        n = torch.broadcast_to(_f32(num_examples, dev), (u.shape[0],))[:, None]
        inv_covar = 1.0 / (1.0 / n + _f32(plda.psi, dev)[None, :])
        factor = torch.sqrt(d / (u * inv_covar * u).sum(1))
    return u * factor[:, None]


def _score_matrix(enroll, test, psi, n_enroll):
    """(M, D) enroll, (P, D) test, (M,) counts → (M, P) LLR matrix."""
    psi = psi[None, :]                                   # (1, D)
    n = n_enroll[:, None]                                # (M, 1)
    m = (n * psi / (n * psi + 1.0)) * enroll             # (M, D) same-mean
    v_same = 1.0 + psi / (n * psi + 1.0)                 # (M, D)
    v_diff = 1.0 + psi[0]                                # (D,)
    d = test.shape[1]

    row = torch.sum(torch.log(v_same) + m.square() / v_same, dim=1)  # (M,)
    t2 = test.square()
    quad = t2 @ (1.0 / v_same).T                         # (P, M)
    cross = test @ (m / v_same).T                        # (P, M)
    ll_same = -0.5 * (row[None, :] + d * _LOG_2PI + quad - 2.0 * cross)
    ll_diff = -0.5 * (torch.sum(torch.log(v_diff)) + d * _LOG_2PI
                      + t2 @ (1.0 / v_diff))             # (P,)
    return (ll_same - ll_diff[:, None]).T                # (M, P)


@_full_f32()
def score_matrix(plda: Plda, enroll, test, n_enroll=1,
                 device="cuda") -> torch.Tensor:
    """Full enroll×test LLR matrix on the device, an (M, P) float32 tensor.

    ``enroll``/``test`` are *projected* vectors (see
    :func:`project_device`); ``n_enroll`` is scalar or (M,) utterance
    counts for the multi-enroll normalisation (``--num-utts`` in
    ``ivector-plda-scoring``)."""
    dev = resolve_device(device)
    enroll = torch.atleast_2d(_f32(enroll, dev))
    test = torch.atleast_2d(_f32(test, dev))
    n = torch.broadcast_to(_f32(n_enroll, dev), (enroll.shape[0],))
    return _score_matrix(enroll, test, _f32(plda.psi, dev), n)


@_full_f32()
def score_trials_device(plda: Plda,
                        enroll_vecs: Dict[str, np.ndarray],
                        test_vecs: Dict[str, np.ndarray],
                        trials: Sequence[Tuple[str, str]],
                        num_utts: Optional[Dict[str, int]] = None,
                        device="cuda") -> np.ndarray:
    """Device counterpart of :meth:`Plda.score_trials`: project all
    vectors, compute the full score matrix, gather the trial entries in
    trial order.  The gather runs on the device (index tensors), so only
    the trials' scores come back to the host: the same values upstream's
    host-side gather of the whole matrix gives.  Returns float32 (N,).
    Worthwhile when len(trials) ≳ M·P/10 (SRE16-style dense trial grids);
    for sparse lists the host path avoids the M×P work."""
    dev = resolve_device(device)
    e_keys = list(enroll_vecs)
    t_keys = list(test_vecs)
    e_idx = {k: i for i, k in enumerate(e_keys)}
    t_idx = {k: i for i, k in enumerate(t_keys)}
    n = np.array([(num_utts or {}).get(k, 1) for k in e_keys], np.float32)
    e = project_device(plda, np.stack([enroll_vecs[k] for k in e_keys]),
                       num_examples=n, device=dev)
    t = project_device(plda, np.stack([test_vecs[k] for k in t_keys]),
                       device=dev)
    s = score_matrix(plda, e, t, n, device=dev)
    rows = torch.from_numpy(np.array([e_idx[a] for a, _ in trials],
                                     np.int64)).to(dev)
    cols = torch.from_numpy(np.array([t_idx[b] for _, b in trials],
                                     np.int64)).to(dev)
    return s[rows, cols].cpu().numpy()


# ---------------------------------------------------------------------------
# Two-covariance EM on the device (K15, ivector-compute-plda)
# ---------------------------------------------------------------------------
#
# The host EM (plda.train_plda) loops over speakers; on the device the
# E-step collapses to sufficient statistics.  With centered per-speaker
# sums s_i (S, D), counts n_i, and the one-time global scatter T = Σ_ij v vᵀ:
#
#   cov_n  = (B⁻¹ + n W⁻¹)⁻¹            — one D×D inverse per UNIQUE count
#   ŷ_i    = cov_{n_i} W⁻¹ s_i          — batched matvec (einsum)
#   B_acc  = Σ_k m_k cov_k + ŶᵀŶ
#   W_acc  = T − ŶᵀS − SᵀŶ + (n⊙Ŷ)ᵀŶ + Σ_k n_k m_k cov_k
#
# i.e. the whole M-step is four (S, D)×(D, S)-shaped contractions plus one
# batched inverse of K ≈ dozens of small matrices, whatever the utterance
# counts.  The iterations run in float32 (as upstream); the statistics and
# the final diagonalisation are float64 on the host.

def _em_stats(spk2vecs: Dict[str, np.ndarray]):
    groups = [np.asarray(v, np.float64).reshape(-1, np.asarray(v).shape[-1])
              for v in spk2vecs.values() if len(v) >= 1]
    counts = np.array([len(g) for g in groups], np.float64)
    all_v = np.concatenate(groups)
    mean = all_v.mean(0)
    all_v -= mean
    # per-speaker sums via one reduceat over the concatenated block; the
    # global scatter is a single GEMM (groups are already centered, so
    # Σ_g gᵀg = VᵀV) — no per-speaker Python loop.
    starts = np.concatenate([[0], np.cumsum(counts[:-1]).astype(np.int64)])
    sums = np.add.reduceat(all_v, starts, axis=0)          # (S, D)
    scatter = all_v.T @ all_v                               # (D, D)
    return mean, sums, counts, scatter


def _make_em_step(unique_counts, m_per_count, count_idx, n_spk, n_tot,
                  ridge, dev):
    uc = torch.as_tensor(unique_counts, dtype=torch.float32, device=dev)
    mk = torch.as_tensor(m_per_count, dtype=torch.float32, device=dev)
    idx = torch.as_tensor(count_idx, dtype=torch.int64, device=dev)

    def step(carry, sums, counts, scatter, eye):
        b, w = carry
        w_inv = torch.linalg.inv(w)
        b_inv = torch.linalg.inv(b)
        cov_u = torch.linalg.inv(b_inv[None] + uc[:, None, None]
                                 * w_inv[None])                # (K, D, D)
        u = sums @ w_inv.T                                     # (S, D)
        yhat = torch.einsum("sd,sde->se", u, cov_u[idx])       # (S, D)
        yty = yhat.T @ yhat
        b_acc = torch.einsum("k,kde->de", mk, cov_u) + yty
        ys = yhat.T @ sums
        nyy = (counts[:, None] * yhat).T @ yhat
        w_acc = (scatter - ys - ys.T + nyy
                 + torch.einsum("k,k,kde->de", uc, mk, cov_u))
        b = b_acc / n_spk + ridge * eye
        w = w_acc / n_tot + ridge * eye
        return b, w

    return step


@_full_f32()
def train_plda_device(spk2vecs: Dict[str, np.ndarray],
                      num_em_iters: int = 10, device="cuda") -> Plda:
    """Device counterpart of :func:`.plda.train_plda` (two-covariance EM,
    same initialisation and ridge): the E/M steps are batched contractions
    over per-speaker sufficient statistics, with one posterior-covariance
    inverse per unique utterance count.  Use when speaker counts make the
    host's per-speaker Python loop the bottleneck."""
    dev = resolve_device(device)
    mean, sums, counts, scatter = _em_stats(spk2vecs)
    d = sums.shape[1]
    n_spk, n_tot = len(counts), counts.sum()

    tot = scatter / n_tot
    ridge = 1e-4 * np.trace(tot) / d + 1e-8
    init = (tot / 2 + ridge * np.eye(d)).astype(np.float32)

    unique_counts, inverse = np.unique(counts, return_inverse=True)
    inverse = inverse.reshape(-1)      # numpy 2 shapes it like the input
    m_per_count = np.bincount(inverse).astype(np.float64)

    step = _make_em_step(unique_counts, m_per_count, inverse,
                         float(n_spk), float(n_tot), float(ridge), dev)
    sums32, counts32, scatter32 = (_f32(a, dev)
                                   for a in (sums, counts, scatter))
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    bw = (_f32(init, dev), _f32(init, dev))
    for _ in range(num_em_iters):
        bw = step(bw, sums32, counts32, scatter32, eye)
    b, w = (np.asarray(x.cpu().numpy(), np.float64) for x in bw)
    return _from_covariances(mean, b, w)
