"""Gaussian-process Bayesian optimization for the autotuner (a copy of
``horovod_tpu/utils/bayesian.py``, numpy and scipy only).

Reference: ``horovod/common/optim/gaussian_process.{h,cc}`` (GP
regression with an RBF kernel, expected-improvement acquisition,
L-BFGS maximization) and ``optim/bayesian_optimization.{h,cc}`` driving
it over the tunable-parameter space.  Same design in numpy/scipy: the
sample counts are tiny (tens), so exact GP posteriors are cheap.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class GaussianProcess:
    """Exact GP regression with an RBF kernel (reference
    ``gaussian_process.cc``: squared-exponential with length-scale ``l``
    and signal variance ``sigma_f``; observation noise ``sigma_n``)."""

    def __init__(self, length_scale: float = 1.0, sigma_f: float = 1.0,
                 sigma_n: float = 1e-4):
        self.length_scale = length_scale
        self.sigma_f = sigma_f
        self.sigma_n = sigma_n
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._l_chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.sigma_f ** 2 * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        from scipy.linalg import cho_factor, cho_solve

        self._x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).reshape(-1)
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.sigma_n ** 2
        self._l_chol = cho_factor(k, lower=True)
        self._alpha = cho_solve(self._l_chol, y)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at query points."""
        from scipy.linalg import cho_solve

        x = np.atleast_2d(np.asarray(x, np.float64))
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha
        v = cho_solve(self._l_chol, ks.T)
        var = self.sigma_f ** 2 - np.sum(ks * v.T, axis=1)
        return mean, np.sqrt(np.maximum(var, 1e-12))


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (reference ``bayesian_optimization.cc``; maximizing)."""
    from scipy.stats import norm

    imp = mean - best - xi
    z = np.where(std > 0, imp / std, 0.0)
    ei = imp * norm.cdf(z) + std * norm.pdf(z)
    return np.where(std > 0, ei, 0.0)


class BayesianOptimizer:
    """Suggest-observe loop over a box-bounded space (normalized to the
    unit cube internally; observations standardized)."""

    def __init__(self, bounds: Sequence[Tuple[float, float]],
                 seed: int = 0, num_candidates: int = 512,
                 noise: float = 1e-4):
        self._bounds = np.asarray(bounds, np.float64)
        self._rng = np.random.RandomState(seed)
        self._num_candidates = num_candidates
        self._noise = float(noise)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []

    def observe(self, x: Sequence[float], y: float) -> None:
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        self._xs.append((np.asarray(x, np.float64) - lo) / (hi - lo))
        self._ys.append(float(y))

    def suggest(self) -> np.ndarray:
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        dim = len(self._bounds)
        if len(self._xs) < 2:
            return lo + (hi - lo) * self._rng.rand(dim)
        ys = np.asarray(self._ys)
        mu, sd = ys.mean(), max(ys.std(), 1e-12)
        gp = GaussianProcess(length_scale=0.3, sigma_n=self._noise)
        gp.fit(np.stack(self._xs), (ys - mu) / sd)
        cand = self._rng.rand(self._num_candidates, dim)
        mean, std = gp.predict(cand)
        ei = expected_improvement(mean, std, float((ys.max() - mu) / sd))
        best = cand[int(np.argmax(ei))]
        return lo + (hi - lo) * best

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmax(self._ys))
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        return lo + (hi - lo) * self._xs[i], self._ys[i]
