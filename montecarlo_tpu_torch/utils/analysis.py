"""Post-run statistical analysis of Monte Carlo time series.

A copy of ``montecarlo_tpu/utils/analysis.py`` (the port imports nothing of
the JAX package, not even its numpy-only modules): normalised
autocorrelation functions, integrated autocorrelation time (Sokal's
self-consistent window), effective sample size, Flyvbjerg-Petersen blocking
errors, a one-call ``summary`` that turns an ``energy.dat``-style series
into ``mean ± err (tau_int, n_eff)``, the jackknife, the Binder cumulant
and histogram reweighting.

Host-side numpy on purpose: these run once on small recorder outputs after
the device loop has finished, so they take numpy arrays, not tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "autocorrelation",
    "integrated_autocorr_time",
    "effective_sample_size",
    "blocking_error",
    "SeriesStats",
    "summary",
    "jackknife",
    "binder_cumulant",
    "reweight",
    "multi_reweight",
]


def autocorrelation(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Normalised autocorrelation function rho(0..max_lag) via FFT.

    ``rho[0] == 1``; O(n log n) through the Wiener–Khinchin theorem.
    """
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    if n < 2:
        raise ValueError("need at least 2 samples")
    if max_lag is None:
        max_lag = n - 1
    max_lag = min(int(max_lag), n - 1)
    xc = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()        # zero-pad to avoid circular wrap
    f = np.fft.rfft(xc, m)
    acov = np.fft.irfft(f * np.conj(f), m)[: max_lag + 1]
    if acov[0] <= 0:                          # constant series
        rho = np.zeros(max_lag + 1)
        rho[0] = 1.0
        return rho
    return acov / acov[0]


def integrated_autocorr_time(x: np.ndarray, c: float = 5.0) -> float:
    """Integrated autocorrelation time tau_int with Sokal's windowing.

    ``tau = 1 + 2 sum_{k=1..W} rho(k)`` with the self-consistent window
    ``W = min{ k : k >= c * tau(k) }`` (Sokal 1997; emcee uses the same rule).
    For iid samples tau ≈ 1; the variance of the sample mean is
    ``var(x) * tau / n``.
    """
    rho = autocorrelation(x)
    tau = 2.0 * np.cumsum(rho) - 1.0          # tau(k) = 1 + 2 sum_{1..k} rho
    window = np.arange(len(tau)) >= c * tau
    if not window.any():
        return float(tau[-1])
    w = int(np.argmax(window))
    return float(max(tau[w], 1.0))


def effective_sample_size(x: np.ndarray, c: float = 5.0) -> float:
    """n / tau_int — the number of statistically independent samples."""
    x = np.asarray(x).ravel()
    return x.size / integrated_autocorr_time(x, c=c)


def blocking_error(x: np.ndarray, min_blocks: int = 32) -> float:
    """Standard error of the mean by Flyvbjerg–Petersen blocking.

    Repeatedly average neighbouring pairs; the naive error
    ``sqrt(var / (n-1))`` of the blocked series grows until blocks are longer
    than the correlation time, then plateaus.  Returns the plateau (maximum
    over levels that retain ≥ ``min_blocks`` blocks, so the plateau estimate
    itself is not noise-dominated).
    """
    x = np.asarray(x, np.float64).ravel()
    if x.size < 2:
        raise ValueError("need at least 2 samples")
    errs = []
    while x.size >= max(2, min_blocks):
        errs.append(np.sqrt(x.var(ddof=1) / x.size))
        if x.size % 2:
            x = x[:-1]
        x = 0.5 * (x[::2] + x[1::2])
    if not errs:
        errs = [np.sqrt(x.var(ddof=1) / x.size)]
    return float(max(errs))


@dataclasses.dataclass(frozen=True)
class SeriesStats:
    mean: float
    error: float          # autocorrelation-corrected std error of the mean
    std: float            # sample standard deviation
    tau_int: float        # integrated autocorrelation time
    n: int                # number of samples
    n_eff: float          # effective sample size n / tau_int

    def __str__(self):
        return (f"{self.mean:.6g} ± {self.error:.2g} "
                f"(std {self.std:.4g}, tau_int {self.tau_int:.2f}, "
                f"n_eff {self.n_eff:.0f}/{self.n})")


def summary(x: np.ndarray, c: float = 5.0) -> SeriesStats:
    """One-call ``mean ± err`` with autocorrelation-corrected error bars.

    Accepts a raw 1-D series or a recorder file's ``(n, 2)`` ``t value``
    array (as returned by ``np.loadtxt`` on ``energy.dat`` etc.) — the value
    column is used.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 2 and x.shape[1] == 2:
        x = x[:, 1]
    x = x.ravel()
    if x.size == 1:
        # autocorrelation() needs n >= 2; a single sample still has a
        # well-defined (if useless) summary.
        return SeriesStats(mean=float(x[0]), error=0.0, std=0.0,
                           tau_int=1.0, n=1, n_eff=1.0)
    tau = integrated_autocorr_time(x, c=c)
    var = x.var(ddof=1) if x.size > 1 else 0.0
    err = float(np.sqrt(var * tau / x.size))
    return SeriesStats(mean=float(x.mean()), error=err,
                       std=float(np.sqrt(var)), tau_int=tau,
                       n=int(x.size), n_eff=x.size / tau)


def jackknife(x: np.ndarray, estimator=np.mean, n_blocks: int = 32):
    """Block-jackknife estimate and standard error of any statistic.

    Splits the series into ``n_blocks`` contiguous blocks (contiguity makes
    the deletion blocks approximately independent for correlated MC series,
    provided blocks are longer than tau_int), evaluates ``estimator`` on each
    leave-one-block-out sample, and returns
    ``(bias-corrected estimate, jackknife error)``.

    Works for nonlinear statistics (variance ratios, cumulants, reweighted
    expectations) where naive error propagation fails.
    """
    x = np.asarray(x, np.float64).ravel()
    n_blocks = int(min(n_blocks, x.size))
    if n_blocks < 2:
        raise ValueError("jackknife needs at least 2 blocks")
    blocks = np.array_split(x, n_blocks)
    full = float(estimator(x))
    loo = np.array([
        float(estimator(np.concatenate(blocks[:k] + blocks[k + 1:])))
        for k in range(n_blocks)])
    m = loo.mean()
    est = n_blocks * full - (n_blocks - 1) * m          # bias-corrected
    err = np.sqrt((n_blocks - 1) / n_blocks * np.sum((loo - m) ** 2))
    return float(est), float(err)


def binder_cumulant(m: np.ndarray, n_blocks: int = 32):
    """Binder cumulant U4 = 1 - <m^4> / (3 <m^2>^2) with jackknife error.

    The standard dimensionless crossing-point diagnostic for locating
    continuous transitions from magnetisation-like series: U4 -> 0 in the
    disordered (Gaussian) phase, -> 2/3 in the ordered phase, and curves for
    different lattice sizes cross at the critical coupling.
    Returns ``(U4, error)``.
    """
    m = np.asarray(m, np.float64).ravel()

    def u4(s):
        m2 = np.mean(s * s)
        m4 = np.mean(s ** 4)
        return 1.0 - m4 / (3.0 * m2 * m2)

    return jackknife(m, u4, n_blocks=n_blocks)


def reweight(energy: np.ndarray, obs: np.ndarray, beta_from: float,
             beta_to: float):
    """Single-histogram (Ferrenberg–Swendsen) reweighting.

    Given samples drawn at ``beta_from`` with total energies ``energy`` and
    per-sample observable values ``obs``, estimates ``<obs>`` at ``beta_to``:

        <O>_b1 = sum O exp(-(b1-b0) E) / sum exp(-(b1-b0) E)

    (log-sum-exp stabilised).  Reliable while the target Boltzmann weight
    still overlaps the sampled energy histogram — in practice
    ``|b1 - b0| * std(E) <~ a few``.
    """
    e = np.asarray(energy, np.float64).ravel()
    o = np.asarray(obs, np.float64).ravel()
    if e.shape != o.shape:
        raise ValueError("energy and obs series must have the same length")
    logw = -(beta_to - beta_from) * e
    logw -= logw.max()
    w = np.exp(logw)
    return float(np.sum(w * o) / np.sum(w))


def multi_reweight(betas, energies, beta_to, obs=None, n_iter: int = 200,
                   tol: float = 1e-10):
    """Multiple-histogram reweighting (WHAM / multi-temperature
    Ferrenberg–Swendsen).

    Combines runs at several temperatures into one density-of-states
    estimate, then evaluates ``<obs>`` (or, with ``obs=None``, ``<E>``) at
    ``beta_to`` — interpolating *between* simulated temperatures, which
    single-histogram reweighting cannot do reliably.

    Args:
      betas: sequence of R simulated inverse temperatures.
      energies: sequence of R 1-D arrays of sampled total energies.
      beta_to: target inverse temperature.
      obs: optional sequence of R arrays (same shapes as ``energies``) of
        per-sample observable values.
      n_iter / tol: self-consistency iteration controls for the per-run
        log-partition-function offsets f_r.

    Solves (iteratively, in log space)

        f_r = -log sum_i exp(-b_r E_i) / sum_s n_s exp(f_s - b_s E_i)

    then reweights every pooled sample to ``beta_to``.
    """
    betas = np.asarray(list(betas), np.float64)
    runs = [np.asarray(e, np.float64).ravel() for e in energies]
    if len(runs) != betas.size:
        raise ValueError("need one energy series per beta")
    if obs is not None:
        obs_runs = [np.asarray(o, np.float64).ravel() for o in obs]
        if any(o.shape != e.shape for o, e in zip(obs_runs, runs)):
            raise ValueError("obs series must match energy series shapes")
    e_all = np.concatenate(runs)
    n_r = np.array([e.size for e in runs], np.float64)
    log_n = np.log(n_r)

    # log-space WHAM iteration for f_r (f_0 pinned to 0)
    f = np.zeros(betas.size)
    neg_be = -np.outer(betas, e_all)                     # (R, N)
    for _ in range(n_iter):
        # log denominator per sample: log sum_s exp(log n_s + f_s - b_s E_i)
        a = log_n[:, None] + f[:, None] + neg_be
        amax = a.max(axis=0)
        log_den = amax + np.log(np.exp(a - amax).sum(axis=0))
        b = neg_be - log_den[None, :]
        bmax = b.max(axis=1)
        f_new = -(bmax + np.log(np.exp(b - bmax[:, None]).sum(axis=1)))
        f_new -= f_new[0]
        if np.max(np.abs(f_new - f)) < tol:
            f = f_new
            break
        f = f_new

    # weights of every pooled sample at beta_to
    a = log_n[:, None] + f[:, None] + neg_be
    amax = a.max(axis=0)
    log_den = amax + np.log(np.exp(a - amax).sum(axis=0))
    logw = -beta_to * e_all - log_den
    logw -= logw.max()
    w = np.exp(logw)
    o_all = e_all if obs is None else np.concatenate(obs_runs)
    return float(np.sum(w * o_all) / np.sum(w))
