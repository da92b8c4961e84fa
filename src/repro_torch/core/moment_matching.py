"""Moment matching between LLN and Softmax attention (paper Appendix A.7).

Port of ``repro.core.moment_matching``: the shipped (a, b) tables as data,
:func:`constants_for_dim`, the beta(n) schedule :func:`length_gain`, the
eq. 10 solver :func:`solve_alpha_beta`, the attention matrices of eq. 6
and eq. 9 on raw inputs, the (a, b) fit (App. A.7) and the running
per-head statistics :class:`QKStats`.

Eq. 10 splits the matched log-variance symmetrically::

    alpha = sigma_tilde / (sqrt(2) * sigma_q)
    beta  = sigma_tilde / (sqrt(2) * sigma_k)
    sigma_tilde = sqrt((sigma_q^2 sigma_k^2 - b) / a)

The (a, b) tables below are the reference's shipped fit (d=64/128,
N=1024 over sigma_tilde^2 in [1, 36]).  :func:`fit_lln_constants` refits
them from Gaussian samples drawn by a seeded ``torch.Generator`` on the
target device: the same procedure, but not the reference's random stream
(``jax.random``), so a fresh fit is close to the tables, not equal to them.
Regenerate with ``python -m repro_torch.core.moment_matching [--grid]
[--device cpu]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

FITTED_CONSTANTS: dict[int, Tuple[float, float]] = {
    64: (0.1935, -0.7577),
    128: (0.1706, -0.7442),
}
DEFAULT_A, DEFAULT_B = FITTED_CONSTANTS[64]

CALIB_LEN = 1024  # reference length n0 the schedules are anchored at
FITTED_CONSTANTS_N: dict[int, dict[int, Tuple[float, float]]] = {
    64: {256: (0.1994, -0.7749), 1024: (0.1873, -0.6735),
         4096: (0.1837, -0.6729)},
    128: {256: (0.1674, -0.7008), 1024: (0.1620, -0.6534),
          4096: (0.1601, -0.6568)},
}


def constants_for_dim(head_dim: int, n: int | None = None,
                      ) -> Tuple[float, float]:
    """Nearest calibrated (a, b) for a head dimension.

    With ``n`` above the calibration length, picks the nearest-N entry
    (nearest in log N) of :data:`FITTED_CONSTANTS_N`; otherwise returns the
    :data:`FITTED_CONSTANTS` defaults.
    """
    best = min(FITTED_CONSTANTS, key=lambda d: abs(d - head_dim))
    if n is None or int(n) <= CALIB_LEN:
        return FITTED_CONSTANTS[best]
    grid = FITTED_CONSTANTS_N[best]
    ln = math.log(max(int(n), 1))
    bn = min(grid, key=lambda m: abs(math.log(m) - ln))
    return grid[bn]


def length_gain(n, beta_n: float = 0.0, calib_len: int = CALIB_LEN
                ) -> torch.Tensor:
    """Gain g(n) = sqrt(1 + beta_n * ln(n / n0)) on (alpha, beta) past the
    calibration length n0, exactly 1 at or below it.  ``n`` may be an int
    or a per-row (B,) tensor; the result broadcasts like ``n``."""
    nf = torch.as_tensor(n, dtype=torch.float32)
    if beta_n <= 0.0:
        return torch.ones_like(nf)
    nf = torch.clamp(nf, min=1.0)
    ratio = torch.clamp(nf / float(max(calib_len, 1)), min=1.0)
    return torch.sqrt(1.0 + float(beta_n) * torch.log(ratio))


def solve_alpha_beta(
    sigma_q,
    sigma_k,
    a: float = DEFAULT_A,
    b: float = DEFAULT_B,
    min_sigma_tilde_sq: float = 1e-4,
    n=None,
    beta_n: float = 0.0,
    calib_len: int = CALIB_LEN,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 10.  sigma_q/sigma_k: scalars or per-head tensors (fp32; no
    gradient: moment matching is a calibration, not a learning signal).
    ``n``/``beta_n`` scale the solution by :func:`length_gain`."""
    sq = torch.as_tensor(sigma_q, dtype=torch.float32).detach()
    sk = torch.as_tensor(sigma_k, dtype=torch.float32).detach()
    sigma_sm_sq = torch.square(sq) * torch.square(sk)
    st = torch.sqrt(torch.clamp((sigma_sm_sq - b) / a,
                                min=min_sigma_tilde_sq))
    alpha = st / (math.sqrt(2.0) * torch.clamp(sq, min=1e-4))
    beta = st / (math.sqrt(2.0) * torch.clamp(sk, min=1e-4))
    if n is not None and beta_n > 0.0:
        gain = length_gain(n, beta_n, calib_len).to(alpha.device)
        if gain.ndim and alpha.ndim > gain.ndim:   # (B,) gain vs (B, H) sol
            gain = gain[..., None]
        alpha = alpha * gain
        beta = beta * gain
    return alpha, beta


# ---------------------------------------------------------------------------
# Attention matrices on raw Gaussian inputs (analysis-scale only).
# ---------------------------------------------------------------------------

def softmax_attn_matrix(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P^(SM) (eq. 6) for q, k: (N, d).  Returns (N, N) rows summing to 1."""
    scores = (q @ k.T) / math.sqrt(q.shape[-1])
    return torch.softmax(scores, dim=-1)


def lln_attn_matrix(q: torch.Tensor, k: torch.Tensor, alpha: float,
                    beta: float) -> torch.Tensor:
    """P^(LLN) (eq. 9) for q, k: (N, d).  Returns (N, N) rows summing to 1."""
    fq = torch.exp(alpha * q - torch.max(alpha * q))
    fk = torch.exp(beta * k - torch.max(beta * k))
    scores = fq @ fk.T
    return scores / (torch.sum(scores, dim=-1, keepdim=True) + 1e-30)


def log_variance(p: torch.Tensor) -> torch.Tensor:
    """Variance of ln(P): the log-normal shape parameter estimate."""
    logp = torch.log(torch.clamp(p, min=1e-30))
    return torch.var(logp, unbiased=False)


# ---------------------------------------------------------------------------
# (a, b) calibration (paper App. A.7).
# ---------------------------------------------------------------------------

def _fit_from_samples(samples: Iterable) -> Tuple[float, float]:
    """Least-squares line Var[ln P^(LLN)] = a * sigma_tilde^2 + b through
    ``(sigma_tilde^2, q, k)`` samples, P^(LLN) at alpha = beta = 1."""
    xs, ys = [], []
    for s2, q, k in samples:
        xs.append(float(s2))
        ys.append(float(log_variance(lln_attn_matrix(q, k, 1.0, 1.0))))
    a, b = np.polyfit(np.asarray(xs), np.asarray(ys), 1)
    return float(a), float(b)


def fit_lln_constants(
    d: int = 64,
    n: int = 1024,
    sigma_tilde_sq: Optional[np.ndarray] = None,
    num_seeds: int = 4,
    seed: int = 0,
    device=None,
) -> Tuple[float, float]:
    """Fit Var[ln P^(LLN)] = a * sigma_tilde^2 + b on Gaussian samples.

    alpha = beta = 1 and sigma_q = sigma_k = sigma_tilde / sqrt(2), so the
    abscissa is exactly sigma_tilde^2 = alpha^2 s_q^2 + beta^2 s_k^2.  The
    (n, d) samples come from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the CUDA card unless the caller asks for another device).
    """
    dev = resolve_device(device)
    if sigma_tilde_sq is None:
        sigma_tilde_sq = np.linspace(1.0, 36.0, 15)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def samples():
        for s2 in sigma_tilde_sq:
            sig = float(np.sqrt(s2 / 2.0))
            for _ in range(num_seeds):
                q = sig * torch.randn(n, d, generator=gen, device=dev)
                k = sig * torch.randn(n, d, generator=gen, device=dev)
                yield s2, q, k

    return _fit_from_samples(samples())


def fit_lln_constants_grid(
    d: int = 64,
    ns: Tuple[int, ...] = (256, 1024, 4096),
    num_seeds: int = 4,
    seed: int = 0,
    device=None,
) -> dict[int, Tuple[float, float]]:
    """Length-aware fit: (a, b) per sequence length N (FITTED_CONSTANTS_N)."""
    return {n: fit_lln_constants(d=d, n=n, num_seeds=num_seeds, seed=seed,
                                 device=device)
            for n in ns}


# ---------------------------------------------------------------------------
# Running input statistics (per-head EMA of sigma_q / sigma_k).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QKStats:
    """Per-head EMA of query/key standard deviations (batchnorm-style)."""
    sigma_q: torch.Tensor   # (H,)
    sigma_k: torch.Tensor   # (H,)

    @staticmethod
    def init(heads: int, device=None) -> "QKStats":
        dev = resolve_device(device)
        return QKStats(sigma_q=torch.ones(heads, device=dev),
                       sigma_k=torch.ones(heads, device=dev))


def _masked_rms(x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Per-head RMS over (B, N, D) of a (B, N, H, D) tensor, optionally
    excluding padded positions via a (B, N) mask."""
    x2 = torch.square(x.float())
    if mask is None:
        return torch.sqrt(torch.mean(x2, dim=(0, 1, 3)))
    m = torch.as_tensor(mask, dtype=torch.float32,
                        device=x.device)[:, :, None, None]
    num = torch.sum(x2 * m, dim=(0, 1, 3))
    den = torch.clamp(torch.sum(m) * x.shape[-1], min=1.0)
    return torch.sqrt(num / den)


def update_stats(stats: QKStats, q: torch.Tensor, k: torch.Tensor,
                 decay: float = 0.99,
                 mask: Optional[torch.Tensor] = None) -> QKStats:
    """EMA update from a (B, N, H, D) batch; no gradient.  ``mask``
    (optional, (B, N), 1 = real token) keeps padded positions out of the
    per-head RMS, so a ragged batch does not pull the EMA toward zero."""
    sq = _masked_rms(q, mask).detach()
    sk = _masked_rms(k, mask).detach()
    return QKStats(sigma_q=decay * stats.sigma_q + (1 - decay) * sq,
                   sigma_k=decay * stats.sigma_k + (1 - decay) * sk)


def matched_alpha_beta(stats: QKStats, a: float = DEFAULT_A,
                       b: float = DEFAULT_B
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return solve_alpha_beta(stats.sigma_q, stats.sigma_k, a, b)


if __name__ == "__main__":
    import sys
    dev = sys.argv[sys.argv.index("--device") + 1] \
        if "--device" in sys.argv else None
    if "--grid" in sys.argv:
        for d in sorted(FITTED_CONSTANTS_N):
            got = fit_lln_constants_grid(d=d, device=dev)
            print(f"d={d}: " + ", ".join(
                f"n={n}: ({a:.4f}, {b:.4f})" for n, (a, b) in got.items()))
    else:
        a, b = fit_lln_constants(device=dev)
        print(f"fit: a={a:.4f} b={b:.4f}  "
              f"(defaults: a={DEFAULT_A} b={DEFAULT_B})")
