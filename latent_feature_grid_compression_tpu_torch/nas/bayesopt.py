"""Bayesian multi-objective generation for the NAS loop (port of the JAX
package's ``nas/bayesopt.py``; numpy only, so both packages propose the
same configurations from the same seed and observations).

* one GP surrogate per objective (RBF kernel on unit-cube-normalized
  parameters, log-scaled axes linearized by the normalizer), its
  hyperparameters fit by a marginal-likelihood grid search;
* candidates scored by Monte-Carlo expected hypervolume improvement over
  the current Pareto front, with the acceptance thresholds
  (compression_ratio >= 100, psnr >= 30) as the hypervolume reference
  point, clipped below the observed minima so that an all-infeasible early
  front still ranks candidates;
* candidates drawn uniformly from the unit cube plus perturbations of the
  front's configurations.

Used by ``nas.search.MultiObjectiveSearch`` under
``generation_strategy='gp_ehvi'``.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Parameter-space normalization
# ---------------------------------------------------------------------------

class SpaceNormalizer:
    """Map parameter dicts <-> the unit cube (log axes linearized)."""

    def __init__(self, space):
        self.space = list(space)

    def encode(self, params: Dict[str, float]) -> np.ndarray:
        out = np.empty(len(self.space))
        for i, p in enumerate(self.space):
            v = float(params[p.name])
            if p.log:
                out[i] = ((math.log(v) - math.log(p.low))
                          / (math.log(p.high) - math.log(p.low)))
            else:
                out[i] = (v - p.low) / (p.high - p.low)
        return np.clip(out, 0.0, 1.0)

    def decode(self, x: np.ndarray) -> Dict[str, float]:
        params = {}
        for i, p in enumerate(self.space):
            u = float(np.clip(x[i], 0.0, 1.0))
            if p.log:
                v = math.exp(math.log(p.low)
                             + u * (math.log(p.high) - math.log(p.low)))
            else:
                v = p.low + u * (p.high - p.low)
            params[p.name] = int(round(v)) if p.integer else v
        return params


# ---------------------------------------------------------------------------
# GP surrogate (RBF kernel, fixed small grid of hyperparameters)
# ---------------------------------------------------------------------------

def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


class GP:
    """Zero-mean RBF GP on standardized targets."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.y_mean = float(y.mean())
        self.y_std = float(y.std()) or 1.0
        self.y = (y - self.y_mean) / self.y_std
        self.ls, self.noise = self._fit()
        K = _rbf(X, X, self.ls) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(
            self.L.T, np.linalg.solve(self.L, self.y))

    def _fit(self) -> Tuple[float, float]:
        """Marginal-likelihood grid search (cheap: n_trials is tiny)."""
        best, best_ll = (0.3, 1e-3), -np.inf
        n = len(self.X)
        for ls in (0.1, 0.2, 0.3, 0.5, 0.8, 1.2):
            K0 = _rbf(self.X, self.X, ls)
            for noise in (1e-4, 1e-3, 1e-2, 1e-1):
                K = K0 + noise * np.eye(n)
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                a = np.linalg.solve(L.T, np.linalg.solve(L, self.y))
                ll = (-0.5 * float(self.y @ a)
                      - float(np.log(np.diag(L)).sum())
                      - 0.5 * n * math.log(2 * math.pi))
                if ll > best_ll:
                    best, best_ll = (ls, noise), ll
        return best

    def posterior(self, Xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Mean and variance at query points, in original units."""
        Ks = _rbf(Xq, self.X, self.ls)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(1.0 + self.noise - (v * v).sum(0), 1e-12)
        return (mu * self.y_std + self.y_mean, var * self.y_std ** 2)


# ---------------------------------------------------------------------------
# Expected hypervolume improvement (2-objective, Monte Carlo)
# ---------------------------------------------------------------------------

def _hv2(points: np.ndarray, ref: np.ndarray) -> float:
    """Dominated hypervolume of maximization points wrt ``ref``."""
    pts = points[(points[:, 0] > ref[0]) & (points[:, 1] > ref[1])]
    if not len(pts):
        return 0.0
    order = np.argsort(-pts[:, 0])
    hv, prev_y = 0.0, ref[1]
    for x, y in pts[order]:
        if y > prev_y:
            hv += (x - ref[0]) * (y - prev_y)
            prev_y = y
    return hv


def mc_ehvi(mu: np.ndarray, var: np.ndarray, front: np.ndarray,
            ref: np.ndarray, rng: np.random.Generator,
            n_samples: int = 64) -> np.ndarray:
    """Monte-Carlo EHVI of each candidate over the current front.

    mu, var: (n_cand, 2) GP posteriors; front: (n_front, 2) observed
    non-dominated objective vectors; ref: (2,) reference point.
    """
    base = _hv2(front, ref)
    sd = np.sqrt(var)
    n_cand = len(mu)
    out = np.zeros(n_cand)
    draws = rng.standard_normal((n_samples, n_cand, 2))
    for s in range(n_samples):
        y = mu + sd * draws[s]
        for i in range(n_cand):
            out[i] += _hv2(np.vstack([front, y[i]]), ref) - base
    return out / n_samples


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class GPEHVIGenerator:
    """Propose the next configuration by GP-posterior MC-EHVI.

    ``thresholds``: (ratio, psnr) acceptance thresholds used as the
    hypervolume reference point (clipped below the observed minimum so an
    all-infeasible early front still ranks candidates).
    """

    def __init__(self, space, seed: int = 0,
                 thresholds: Tuple[float, float] = (100.0, 30.0),
                 n_candidates: int = 256, n_mc: int = 64):
        self.space = list(space)
        self.norm = SpaceNormalizer(space)
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed + 1)
        self.thresholds = thresholds
        self.n_candidates = n_candidates
        self.n_mc = n_mc

    def _candidates(self, front_X: np.ndarray) -> np.ndarray:
        d = len(self.space)
        n_rand = self.n_candidates - (len(front_X) * 8 if len(front_X) else 0)
        cands = [self.rng.random((max(n_rand, 32), d))]
        if len(front_X):
            jitter = self.rng.normal(0.0, 0.1, (len(front_X) * 8, d))
            local = np.repeat(front_X, 8, axis=0) + jitter
            cands.append(np.clip(local, 0.0, 1.0))
        return np.vstack(cands)

    def suggest(self, observed: Sequence[Tuple[Dict[str, float],
                                               Tuple[float, float]]]
                ) -> Dict[str, float]:
        """observed: [(params, (ratio, psnr)), ...] completed trials."""
        if len(observed) < 3:
            # not enough data for a GP — fall back to space sampling
            return {p.name: p.sample(self.pyrng) for p in self.space}
        X = np.stack([self.norm.encode(p) for p, _ in observed])
        Y = np.asarray([obj for _, obj in observed], dtype=float)
        # objectives are wildly scaled (ratio ~ 1e2..1e3, psnr ~ 30..55):
        # model and score in log-ratio / raw-psnr space
        Yt = np.stack([np.log(np.maximum(Y[:, 0], 1e-6)), Y[:, 1]], axis=1)
        ref = np.asarray([math.log(self.thresholds[0]), self.thresholds[1]])
        ref = np.minimum(ref, Yt.min(0) - 1e-3)

        front_mask = _front_mask(Yt)
        front = Yt[front_mask]
        gps = [GP(X, Yt[:, j]) for j in range(2)]

        cand = self._candidates(X[front_mask])
        mus, vars_ = zip(*(gp.posterior(cand) for gp in gps))
        mu = np.stack(mus, axis=1)
        var = np.stack(vars_, axis=1)
        scores = mc_ehvi(mu, var, front, ref, self.rng, self.n_mc)
        best = int(np.argmax(scores))
        if scores[best] <= 0.0:
            best = int(np.argmax(mu[:, 0] + mu[:, 1]))  # pure exploitation tie-break
        return self.norm.decode(cand[best])


def _front_mask(Y: np.ndarray) -> np.ndarray:
    n = len(Y)
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominated = (Y >= Y[i]).all(1) & (Y > Y[i]).any(1)
        if dominated.any():
            mask[i] = False
    return mask
