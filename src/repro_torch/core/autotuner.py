"""Scale-in auto-tuner (paper §4.2) — host-side worker-pool controller.

From an initial pool of P workers, the scheduler:

1. waits for the loss curve's *knee* (threshold on the first derivative);
2. at the knee, fits the reference curve L_P(t) (Eq. 2) on the fast-
   convergence losses and estimates the reference step duration d_P;
3. immediately evicts one worker, then, on every scheduling interval:
   - *estimation phase*: fits a slow-convergence curve l_p(t) (Eq. 3) on the
     losses observed since the last removal, and re-estimates step duration
     d_p (steps get faster with fewer workers — communication is O~(p));
   - *decision phase*: computes the projected relative loss degradation over
     horizon Delta,

         s_Delta(t) = [L_P(t + floor(Delta/d_P)) - l_p(t + floor(Delta/d_p))]
                      / L_P(t + floor(Delta/d_P)),

     and removes another worker iff s_Delta(t) < S.

The controller is substrate-agnostic: the serverless simulator feeds it
(loss, step-duration) observations and obeys its eviction decisions; the pod
runtime maps decisions onto elastic DP-axis re-meshing (dist/elastic.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import curves


@dataclasses.dataclass(frozen=True)
class AutoTunerConfig:
    threshold_S: float = 0.05  # scaling-down condition s_Delta(t) < S
    sched_interval_s: float = 20.0  # paper §6.2.2
    delta_s: float = 10.0  # horizon Delta (= half the scheduling epoch)
    knee_slope_threshold: float = 0.05
    knee_window: int = 5
    ewma_alpha: float = 0.3
    min_workers: int = 1
    min_points_for_fit: int = 8


@dataclasses.dataclass
class Decision:
    remove_worker: bool
    s_delta: Optional[float]  # None while pre-knee or under-observed
    reason: str


class ScaleInAutoTuner:
    """Stateful controller; one instance per training job."""

    def __init__(self, config: AutoTunerConfig, initial_workers: int):
        self.config = config
        self.P = initial_workers
        self.pool = initial_workers
        # observation streams
        self._steps: list[int] = []
        self._losses: list[float] = []
        self._durations: list[float] = []
        # region bookkeeping
        self.knee_step: Optional[int] = None
        self.reference: Optional[curves.FittedCurve] = None
        self.d_P: Optional[float] = None
        self._last_removal_idx = 0  # index into streams of the last eviction
        self._last_sched_time = 0.0
        self._time = 0.0

    # -- observation ----------------------------------------------------------

    def observe(self, step: int, loss: float, step_duration_s: float) -> None:
        self._steps.append(int(step))
        self._losses.append(float(loss))
        self._durations.append(float(step_duration_s))
        self._time += float(step_duration_s)

    @property
    def smoothed_losses(self) -> np.ndarray:
        return curves.ewma(self._losses, self.config.ewma_alpha)

    # -- phases ---------------------------------------------------------------

    def _maybe_find_knee(self) -> None:
        if self.knee_step is not None:
            return
        idx = curves.detect_knee(
            self.smoothed_losses,
            self.config.knee_slope_threshold,
            self.config.knee_window,
        )
        if idx is None:
            return
        self.knee_step = self._steps[min(idx, len(self._steps) - 1)]
        t = np.asarray(self._steps, dtype=np.float64)
        y = self.smoothed_losses
        self.reference = curves.fit_reference(t, y)
        # Exclude the first observation from the reference step duration: it
        # carries the XLA-compile warm-up (the same policy fig6 applies to
        # measured_step_s_mean), which would inflate d_P and shrink the
        # floor(Delta/d_P) horizon every later decision is scored against.
        steady = self._durations[1:] or self._durations
        self.d_P = float(np.mean(steady))

    def _estimate_current(self) -> tuple[Optional[curves.FittedCurve], float]:
        """Fit l_p(t) on observations since the last removal; estimate d_p."""
        lo = self._last_removal_idx
        if len(self._steps) - lo < self.config.min_points_for_fit:
            return None, float(np.mean(self._durations[lo:] or self._durations))
        t = np.asarray(self._steps[lo:], dtype=np.float64)
        y = curves.ewma(self._losses[lo:], self.config.ewma_alpha)
        return curves.fit_slow(t, y), float(np.mean(self._durations[lo:]))

    # -- decision -------------------------------------------------------------

    def decide(self) -> Decision:
        """Called by the runtime whenever a scheduling interval elapses."""
        cfg = self.config
        self._maybe_find_knee()
        # Interval accounting is uniform across ALL outcomes: an elapsed
        # interval is consumed here, whatever decide() goes on to return.
        # Previously pre-knee/at-min-pool returns left _last_sched_time
        # stale, so the first post-knee decision fired immediately off a
        # timestamp from before the knee was even found.
        interval_elapsed = (
            self._time - self._last_sched_time >= cfg.sched_interval_s
        )
        if interval_elapsed:
            self._last_sched_time = self._time
        if self.knee_step is None:
            return Decision(False, None, "pre-knee")
        if self.pool <= cfg.min_workers:
            return Decision(False, None, "at-min-pool")
        if not interval_elapsed:
            return Decision(False, None, "interval-not-elapsed")

        # First eviction right at the knee (paper: "removes the worker with
        # the lowest-quality replica ... and waits for the next interval").
        if self._last_removal_idx == 0 and self.pool == self.P:
            self._record_removal()
            return Decision(True, None, "knee-initial-eviction")

        ell, d_p = self._estimate_current()
        if ell is None or self.reference is None or self.d_P is None:
            return Decision(False, None, "under-observed")

        t_now = float(self._steps[-1])
        horiz_P = t_now + np.floor(cfg.delta_s / max(self.d_P, 1e-9))
        horiz_p = t_now + np.floor(cfg.delta_s / max(d_p, 1e-9))
        L = float(self.reference(horiz_P))
        l = float(ell(horiz_p))
        s_delta = (L - l) / L if abs(L) > 1e-12 else 0.0

        if s_delta < cfg.threshold_S:
            self._record_removal()
            return Decision(True, s_delta, "scale-in")
        return Decision(False, s_delta, "above-threshold")

    def _record_removal(self) -> None:
        self.pool -= 1
        self._last_removal_idx = len(self._steps)
        self._last_sched_time = self._time

    # -- introspection --------------------------------------------------------

    def summary(self) -> dict:
        return {
            "initial_workers": self.P,
            "final_workers": self.pool,
            "knee_step": self.knee_step,
            "reference_theta": None
            if self.reference is None
            else self.reference.theta.tolist(),
            "d_P": self.d_P,
        }


def evict_and_reintegrate(replicas, evicted: int, active_mask):
    """The simulator's eviction (paper §4.2): the leaving worker publishes
    its replica and every active worker averages it into its own,

        x_p' <- (x_evicted + x_p') / 2

    (the pool size does not enter, unlike ``dist.elastic.
    reintegrate_replicas``). ``replicas`` leaves have a leading worker
    axis (P, ...); ``active_mask`` is a bool (P,) tensor on their device
    with the evicted worker already cleared. The evicted slot is left in
    place, inert."""

    def leaf(x):
        mask = active_mask.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, 0.5 * (x + x[evicted][None]), x)

    return tree_lib.tree_map(leaf, replicas)
