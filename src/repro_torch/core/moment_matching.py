"""Moment matching between LLN and Softmax attention (paper Appendix A.7).

Port of ``repro.core.moment_matching``: the shipped (a, b) tables as data,
:func:`constants_for_dim`, the beta(n) schedule :func:`length_gain` and the
eq. 10 solver :func:`solve_alpha_beta`.

Eq. 10 splits the matched log-variance symmetrically::

    alpha = sigma_tilde / (sqrt(2) * sigma_q)
    beta  = sigma_tilde / (sqrt(2) * sigma_k)
    sigma_tilde = sqrt((sigma_q^2 sigma_k^2 - b) / a)

The (a, b) tables below are the reference's shipped fit (d=64/128,
N=1024 over sigma_tilde^2 in [1, 36]); the fit itself is not ported, since
its output depends on the environment that runs it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

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
