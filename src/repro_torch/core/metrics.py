"""Attention-concentration instruments (paper §3.2), port of
``repro.core.metrics``.

* entropy (eq. 7): the *biased* concentration, monotone increasing in the
  temperature (Thm. 3.2);
* spectral gap gamma = 1 - |lambda_2|: the *unbiased* concentration (Thm.
  3.3: lambda_2^2 equals the variance along the major principal component
  of the centered attention matrix);
* temperatures tau_sm (eq. 5) and tau_lln (eq. 11);
* the streaming instruments, read off the carried LLN decode state.

The matrix instruments take explicit (N, N) attention matrices and are for
small-N probes, not the training path.  Each runs on the device of its
input; the eigen-based ones (:func:`spectral_gap`,
:func:`spectral_gap_power`, :func:`variance_along_pc`) take a tensor or an
array, work in float64 as the reference's numpy does, and return a Python
float.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..distributed.sharding import is_dtensor
from ..tree import leaves_with_path
from .moment_matching import DEFAULT_A, DEFAULT_B


def _f64(p) -> torch.Tensor:
    """A float64 tensor of ``p`` (a tensor keeps its device)."""
    return torch.as_tensor(np.asarray(p) if not torch.is_tensor(p) else p,
                           dtype=torch.float64)


def row_entropy(p: torch.Tensor) -> torch.Tensor:
    """Mean base-2 row entropy of a stochastic matrix (eq. 7).  (..., N, N)."""
    logp = torch.log2(torch.clamp(p, min=1e-30))
    return -torch.mean(torch.sum(p * logp, dim=-1), dim=-1)


def spectral_gap(p) -> float:
    """gamma = 1 - |lambda_2| of a right-stochastic matrix (dense
    eigenvalues, O(N^3))."""
    ev = torch.linalg.eigvals(_f64(p)).abs()
    ev = torch.sort(ev, descending=True).values
    lam2 = float(ev[1]) if ev.numel() > 1 else 0.0
    return float(1.0 - lam2)


def spectral_gap_power(p, iters: int = 200, seed: int = 0) -> float:
    """gamma = 1 - |lambda_2| by deflated power iteration (O(iters * N^2)).

    A right-stochastic P has the dominant pair lambda_1 = 1 with right
    eigenvector 1: power-iterate P^T for the stationary left vector pi,
    deflate B = P - 1 pi^T (eigenvalues {0} and lambda_2, ...), and take
    |lambda_2| from the geometric mean growth rate of B^m x over the second
    half of the iterations (robust to a complex dominant pair).  The start
    vector is the reference's: ``numpy.random.default_rng(seed)``.
    """
    p = _f64(p)
    n = p.shape[-1]
    pi = torch.full((n,), 1.0 / n, dtype=torch.float64, device=p.device)
    for _ in range(iters):
        pi = pi @ p
        pi = pi / pi.sum()
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(
        p.device)
    x = x - pi @ x                      # deflate: remove the lambda_1 mode
    x = x / (torch.linalg.norm(x) + 1e-300)
    burn = iters // 2
    log_rates = []
    for i in range(iters):
        x = p @ x - pi @ x
        nrm = torch.linalg.norm(x)
        if float(nrm) < 1e-300:
            return 1.0
        x = x / nrm
        if i >= burn:                   # geometric mean of late growth rates
            log_rates.append(torch.log(nrm))
    lam = float(torch.exp(torch.stack(log_rates).mean()))
    return float(1.0 - lam)


def variance_along_pc(p) -> float:
    """sigma^2 along the major principal component of the centered matrix
    (Thm. 3.3: equal to lambda_2^2)."""
    p = _f64(p)
    pbar = p - p.mean(dim=0, keepdim=True)
    cov = pbar.T @ pbar
    return float(torch.linalg.eigvalsh(cov).max())


def temperature_sm(sigma_q: float, sigma_k: float, c_cross: float = 0.0
                   ) -> float:
    """tau_sm = 1 / sqrt(sigma_q^2 sigma_k^2 + C_cross)   (eq. 5)."""
    return float(1.0 / math.sqrt(sigma_q ** 2 * sigma_k ** 2 + c_cross))


def temperature_lln(alpha: float, beta: float, sigma_q: float,
                    sigma_k: float, a: float = DEFAULT_A,
                    b: float = DEFAULT_B) -> float:
    """tau_lln = 1 / sqrt(a (alpha^2 s_q^2 + beta^2 s_k^2) + b)   (eq. 11)."""
    s2 = a * (alpha ** 2 * sigma_q ** 2 + beta ** 2 * sigma_k ** 2) + b
    return float(1.0 / math.sqrt(max(s2, 1e-12)))


# ---------------------------------------------------------------------------
# Streaming concentration instruments (serving telemetry): read the carried
# O(d^2) LLN decode state, O(H d) per row, no (N, N) matrix.
# ---------------------------------------------------------------------------

def streaming_concentration(z: torch.Tensor, log_scale=None, c=None,
                            pos=None, a: float = DEFAULT_A,
                            b: float = DEFAULT_B) -> dict:
    """Per-row concentration instruments from the carried LLN state.

    z: (..., B, H, D) accumulated key features Phi(k) = exp(beta k - c_k);
    c: (..., B, H) per-head reference constant ``c_k`` (squeezed);
    log_scale: (..., B, H) accumulated drift-renorm shift (None = zeros);
    pos: (B,) per-row committed depth.  Leading axes (a layer stack) are
    averaged out.  Returns (B,)-shaped fp32 instruments:

    * ``log_mass``: ln sum_d z + c, the reference-free log key mass
      ``ln sum_t exp(beta k_t)``, invariant to the drift renorm and to the
      reference constant (both fold their shift into ``c_k``).  Without
      ``c``, ``log_scale`` corrects the renorm jumps instead;
    * ``conc_drift``: log_mass - ln(pos), the log mass per committed token
      (only with ``pos``): flat over the horizon for a stationary
      concentration;
    * ``log_mass_var``: Var_d[ln z_d], the across-dim dispersion of the key
      log-features, a proxy for the key half of sigma_tilde^2 (Prop. 4.1);
    * ``tau_hat``: 1/sqrt(a * 2 * log_mass_var + b), an eq.-11-shaped
      temperature proxy (its flatness over the horizon is the signal), the
      argument floored at 1e-2.
    """
    lz = torch.log(torch.clamp(z.float(), min=1e-30))
    log_mass = torch.logsumexp(lz, dim=-1)                      # (..., B, H)
    if c is not None:
        log_mass = log_mass + c.float()
    elif log_scale is not None:
        log_mass = log_mass + log_scale.float()
    logvar = torch.var(lz, dim=-1, unbiased=False)              # (..., B, H)
    # Average the heads and any leading (layer) axes; the row axis is -2.
    dims = tuple(i for i in range(log_mass.ndim) if i != log_mass.ndim - 2)
    lm = torch.mean(log_mass, dim=dims)                         # (B,)
    lv = torch.mean(logvar, dim=dims)                           # (B,)
    out = {"log_mass": lm, "log_mass_var": lv,
           "tau_hat": 1.0 / torch.sqrt(torch.clamp(a * 2.0 * lv + b,
                                                   min=1e-2))}
    if pos is not None:
        npos = torch.clamp(torch.as_tensor(pos, dtype=torch.float32,
                                           device=lm.device), min=1.0)
        out["conc_drift"] = lm - torch.log(npos)
    return out


_STATE_FIELDS = ("z", "c_k", "log_scale", "pos")


def streaming_concentration_tree(tree) -> dict | None:
    """:func:`streaming_concentration` over a whole decode-state tree,
    averaged across layers.

    The reference walks a pytree whose per-layer states are stacked along
    a leading layer axis; the port keeps per-layer lists (``{"layers":
    [AttentionState, ...]}``, the hybrid's ``"shared"`` list), so this
    walks those and averages the per-layer instruments (the same mean as
    the reference's over its stacked axis).  Every ``z`` / ``c_k`` /
    ``log_scale`` / ``pos`` leaf is collected by name, with the batch on
    axis 0 as the port's caches keep it; DTensor leaves (a pool on a mesh)
    are gathered whole first, so every rank gets the same instruments.
    Returns None when the tree carries no LLN state (softmax caches and
    the SSM layers have no ``z``).
    """
    found = {name: [] for name in _STATE_FIELDS}
    for path, leaf in leaves_with_path(tree):
        if path and path[-1] in found:
            # On a mesh these O(B H D) leaves come whole to every rank.
            found[path[-1]].append(leaf.full_tensor() if is_dtensor(leaf)
                                   else leaf)
    zs, cs, lss, poss = (found[n] for n in _STATE_FIELDS)
    if not zs:
        return None
    rows = zs[0].shape[0]
    if len(cs) != len(zs):
        cs = [None] * len(zs)
    if len(lss) != len(zs):
        lss = [None] * len(zs)
    per_leaf = [streaming_concentration(
        z, c=None if c is None else c.squeeze(-1).squeeze(-2), log_scale=ls)
        for z, c, ls in zip(zs, cs, lss)]
    out = {k: sum(d[k] for d in per_leaf) / len(per_leaf)
           for k in per_leaf[0]}
    if poss:
        pos = poss[0].reshape(rows, -1)[:, 0]
        npos = torch.clamp(pos.float(), min=1.0)
        out["conc_drift"] = out["log_mass"] - torch.log(npos)
    return out


def attention_log_moments(p: torch.Tensor):
    """(mean, var) of ln P: the log-normal parameters (Prop. 3.1 / 4.1)."""
    logp = torch.log(torch.clamp(p, min=1e-30))
    return torch.mean(logp), torch.var(logp, unbiased=False)


def lognormality_score(p: torch.Tensor, num_q: int = 256) -> float:
    """Quantile-quantile normality check of ln P: the Pearson correlation
    between the empirical quantiles of ln P and Gaussian quantiles (1.0 =
    log-normal).  Runs on P's device in float64 (``torch.quantile`` takes
    up to 2**24 entries); only the Gaussian quantiles' constant abscissae
    come from numpy."""
    logp = torch.log(torch.clamp(p, min=1e-30)).reshape(-1).double()
    probs = (np.arange(1, num_q + 1) - 0.5) / num_q
    emp = torch.quantile(logp, torch.as_tensor(probs, device=logp.device))
    theo = torch.as_tensor(_norm_ppf(probs), device=logp.device)
    return float(torch.corrcoef(torch.stack([emp, theo]))[0, 1])


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """Acklam's inverse-normal-CDF approximation (no scipy dependency)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    p = np.asarray(p, np.float64)
    out = np.empty_like(p)
    plow, phigh = 0.02425, 1 - 0.02425
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if lo.any():
        ql = np.sqrt(-2 * np.log(p[lo]))
        out[lo] = (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql
                    + c[4]) * ql + c[5]) / \
            ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    if hi.any():
        qh = np.sqrt(-2 * np.log(1 - p[hi]))
        out[hi] = -(((((c[0] * qh + c[1]) * qh + c[2]) * qh + c[3]) * qh
                     + c[4]) * qh + c[5]) / \
            ((((d[0] * qh + d[1]) * qh + d[2]) * qh + d[3]) * qh + 1)
    if mid.any():
        qm = p[mid] - 0.5
        r = qm * qm
        out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                    * r + a[5]) * qm / \
            (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    return out
