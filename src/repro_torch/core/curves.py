"""Loss-curve models and fitting for the scale-in auto-tuner (paper §4.2).

Two curve families, per the paper:

* reference (fast-convergence region, Eq. 2):
      L_P(t) = 1 / (th0 * t^th1 + th2) + th3
* slow-convergence (after worker removals, Eq. 3, from SLAQ):
      l_p(t) = 1 / (th0 * t^2 + th1 * t + th2) + th3

with non-negative coefficients, fitted by non-negative least squares on
EWMA-smoothed loss observations. The paper uses scipy's curve_fit; we
implement a projected-gradient NNLS in numpy so the controller has no scipy
dependency on the hot path (scipy is still used in tests as an oracle when
available).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


def ewma(values: Sequence[float], alpha: float = 0.3) -> np.ndarray:
    """Exponentially weighted moving average filter (outlier removal)."""
    values = np.asarray(values, dtype=np.float64)
    out = np.empty_like(values)
    acc = values[0]
    for i, v in enumerate(values):
        acc = alpha * v + (1.0 - alpha) * acc
        out[i] = acc
    return out


def reference_curve(t: np.ndarray, th: np.ndarray) -> np.ndarray:
    """Eq. 2: 1/(th0 * t^th1 + th2) + th3."""
    t = np.asarray(t, dtype=np.float64)
    return 1.0 / (th[0] * np.power(np.maximum(t, 1e-9), th[1]) + th[2] + 1e-12) + th[3]


def slow_curve(t: np.ndarray, th: np.ndarray) -> np.ndarray:
    """Eq. 3: 1/(th0 * t^2 + th1 * t + th2) + th3."""
    t = np.asarray(t, dtype=np.float64)
    return 1.0 / (th[0] * t * t + th[1] * t + th[2] + 1e-12) + th[3]


@dataclasses.dataclass
class FittedCurve:
    kind: str  # "reference" | "slow"
    theta: np.ndarray
    rmse: float

    def __call__(self, t) -> np.ndarray:
        fn = reference_curve if self.kind == "reference" else slow_curve
        return fn(np.asarray(t, dtype=np.float64), self.theta)


def _nnls_fit(
    fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    t: np.ndarray,
    y: np.ndarray,
    theta0: np.ndarray,
    iters: int = 400,
) -> np.ndarray:
    """Projected-gradient least squares with a non-negativity constraint.

    Gauss-Newton-ish: numeric Jacobian, backtracking line search, projection
    onto theta >= 0. Small problems (4 params, <= a few hundred points), so
    an O(iters * n * 4) numeric scheme is plenty.
    """
    theta = np.maximum(np.asarray(theta0, dtype=np.float64), 0.0)
    n = t.size

    def loss(th):
        r = fn(t, th) - y
        return float(np.dot(r, r) / n)

    cur = loss(theta)
    eps = 1e-6
    step = 0.1
    for _ in range(iters):
        # numeric gradient
        g = np.zeros_like(theta)
        for j in range(theta.size):
            th2 = theta.copy()
            th2[j] += eps
            g[j] = (loss(th2) - cur) / eps
        gn = np.linalg.norm(g)
        if gn < 1e-12:
            break
        d = -g / gn
        # backtracking
        improved = False
        s = step
        for _ in range(20):
            cand = np.maximum(theta + s * d, 0.0)
            cl = loss(cand)
            if cl < cur - 1e-15:
                theta, cur = cand, cl
                improved = True
                step = min(s * 1.5, 1.0)
                break
            s *= 0.5
        if not improved:
            step *= 0.5
            if step < 1e-10:
                break
    return theta


def _nnls_linear(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Tiny active-set NNLS: solve min ||A x - b|| s.t. x >= 0.

    Lawson-Hanson on <= 3 columns — exact enough for the curve families.
    """
    n = A.shape[1]
    best_x, best_r = np.zeros(n), float(np.dot(b, b))
    # enumerate support sets (n <= 3 -> at most 8 subsets)
    for mask in range(1, 1 << n):
        cols = [j for j in range(n) if mask >> j & 1]
        sub = A[:, cols]
        sol, *_ = np.linalg.lstsq(sub, b, rcond=None)
        if np.any(sol < 0):
            continue
        r = sub @ sol - b
        rr = float(np.dot(r, r))
        if rr < best_r:
            best_r = rr
            best_x = np.zeros(n)
            best_x[cols] = sol
    return best_x


def _fit_linearized(
    kind: str, t: np.ndarray, y: np.ndarray, basis_fn, assemble,
    n_floor: int = 24
) -> FittedCurve | None:
    """Both paper curves are linear in their denominator coefficients once
    th3 is fixed: 1/(y - th3) = sum_j coef_j * f_j(t). Grid th3 below
    y.min(), solve each by NNLS, keep the best in ORIGINAL loss space.
    ``assemble(coef, th3)`` builds the full theta for the curve family."""
    fn = reference_curve if kind == "reference" else slow_curve
    ymin = float(y.min())
    best = None
    for th3 in np.linspace(0.0, max(ymin - 1e-6, 0.0), n_floor):
        z = y - th3
        if np.any(z <= 1e-9):
            continue
        w = z * z  # weight: d(1/z) errors by z^2 to approximate loss-space LS
        A = basis_fn(t) * w[:, None]
        b = (1.0 / z) * w
        coef = _nnls_linear(A, b)
        th = assemble(coef, th3)
        r = fn(t, th) - y
        rmse = float(np.sqrt(np.mean(r * r)))
        if best is None or rmse < best.rmse:
            best = FittedCurve(kind, th, rmse)
    return best


def fit_reference(t: Sequence[float], y: Sequence[float]) -> FittedCurve:
    """Fit Eq. 2 to (t, y): grid over (exponent th1, floor th3), linear NNLS
    for (th0, th2), then a short projected-gradient polish."""
    t = np.asarray(t, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    best = None
    for th1 in (0.4, 0.5, 0.65, 0.8, 0.9, 1.0, 1.2, 1.5):
        def basis(tt, _e=th1):
            return np.stack([np.power(tt, _e), np.ones_like(tt)], axis=1)

        def assemble(coef, th3, _e=th1):
            return np.array([coef[0], _e, coef[1], th3], dtype=np.float64)

        cand = _fit_linearized("reference", t, y, basis, assemble)
        if cand is not None and (best is None or cand.rmse < best.rmse):
            best = cand
    # polish in full nonlinear form
    th = _nnls_fit(reference_curve, t, y, best.theta, iters=150)
    r = reference_curve(t, th) - y
    rmse = float(np.sqrt(np.mean(r * r)))
    return FittedCurve("reference", th, rmse) if rmse < best.rmse else best


def fit_slow(t: Sequence[float], y: Sequence[float]) -> FittedCurve:
    """Fit Eq. 3 to (t, y): linear NNLS in (th0, th1, th2) per th3 grid."""
    t = np.asarray(t, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)

    def basis(tt):
        return np.stack([tt * tt, tt, np.ones_like(tt)], axis=1)

    def assemble(coef, th3):
        return np.array([coef[0], coef[1], coef[2], th3], dtype=np.float64)

    best = _fit_linearized("slow", t, y, basis, assemble)
    th = _nnls_fit(slow_curve, t, y, best.theta, iters=150)
    r = slow_curve(t, th) - y
    rmse = float(np.sqrt(np.mean(r * r)))
    return FittedCurve("slow", th, rmse) if rmse < best.rmse else best


def detect_knee(losses: Sequence[float], slope_threshold: float = 0.05,
                window: int = 5) -> int | None:
    """Paper's knee heuristic: threshold on the first derivative.

    Returns the first index where the windowed mean |dL/dt|, normalised by the
    initial drop rate, falls below ``slope_threshold``; None if not reached.
    """
    y = np.asarray(losses, dtype=np.float64)
    if y.size < 2 * window + 2:
        return None
    d = np.abs(np.diff(y))
    # windowed slope
    kernel = np.ones(window) / window
    sm = np.convolve(d, kernel, mode="valid")
    ref = max(float(sm[: max(window, 1)].mean()), 1e-12)
    below = np.nonzero(sm / ref < slope_threshold)[0]
    if below.size == 0:
        return None
    return int(below[0] + window)
