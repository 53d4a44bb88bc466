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


@dataclasses.dataclass(frozen=True)
class TopologyTunerConfig:
    explore_steps: int = 6  # measured (post-warmup) steps per cell
    # dropped per cell: the respawned workers' first step after a re-shard
    # (module loads, the first launches and allocations on the card)
    warmup_steps: int = 1
    rel_tolerance: float = 0.05  # p50s within this are a tie


class TopologyTuner:
    """Explore-then-commit co-tuner over topology cells (DESIGN.md §16).

    A *cell* is a full knob assignment ``{n_brokers, transport,
    wire_scheme, shard_split_bytes, partitioner}``; cell 0 is the topology
    the job started with. The tuner spends ``warmup_steps +
    explore_steps`` measured steps in each cell (the warm-up is dropped),
    then commits to the cell with the lowest step-duration p50. Cells
    whose p50s are within ``rel_tolerance`` of the best are tied; ties
    break on the simulator's cost model (``CommModel.
    indirect_exchange_time`` with the cell's broker count), then on p50,
    then on cell order.

    The tuner only recommends: ``next_action()`` returns ``("explore",
    cell)``, ``("commit", cell)`` or ``None``, and the supervisor performs
    the WAL-coordinated handover. ``abandon()`` stops the experiment (the
    job is too close to its end for another fence). Host-side numpy, as
    the scale-in tuner is.
    """

    def __init__(self, cells: list, config: Optional[TopologyTunerConfig]
                 = None, comm=None, bytes_per_step: float = 0.0,
                 n_workers: int = 1):
        if not cells:
            raise ValueError("TopologyTuner needs at least one cell")
        self.cells = [dict(c) for c in cells]
        self.config = config or TopologyTunerConfig()
        self.comm = comm
        self.bytes_per_step = float(bytes_per_step)
        self.n_workers = int(n_workers)
        self.active = 0
        self.committed: Optional[int] = None
        self._abandoned = False
        self._durs: list[list[float]] = [[] for _ in self.cells]
        self._phases: list[dict[str, list[float]]] = [{} for _ in self.cells]

    def observe(self, dur_s: float, phases: Optional[dict] = None) -> None:
        """Feed one measured step of the active cell: its wall duration
        and the per-phase seconds the workers report."""
        self._durs[self.active].append(float(dur_s))
        for k, v in (phases or {}).items():
            self._phases[self.active].setdefault(k, []).append(float(v))

    def _steady(self, i: int) -> list[float]:
        return self._durs[i][self.config.warmup_steps:]

    def cell_stats(self, i: int) -> dict:
        durs = self._steady(i)
        w = self.config.warmup_steps
        return {
            "cell": dict(self.cells[i]),
            "n_steps": len(durs),
            "p50": float(np.percentile(durs, 50)) if durs else None,
            "p95": float(np.percentile(durs, 95)) if durs else None,
            "phase_p50": {k: float(np.percentile(v[w:], 50))
                          for k, v in self._phases[i].items() if v[w:]},
            "phase_p95": {k: float(np.percentile(v[w:], 95))
                          for k, v in self._phases[i].items() if v[w:]},
        }

    def _model_cost(self, cell: dict) -> float:
        if self.comm is None:
            return 0.0
        return float(self.comm.indirect_exchange_time(
            self.bytes_per_step, self.n_workers,
            n_redis=int(cell.get("n_brokers", 1))))

    def _pick_best(self) -> int:
        p50s = [float(np.percentile(self._steady(i), 50))
                if self._steady(i) else float("inf")
                for i in range(len(self.cells))]
        best = min(p50s)
        tied = [i for i, p in enumerate(p50s)
                if p <= best * (1.0 + self.config.rel_tolerance)]
        return min(tied, key=lambda i: (self._model_cost(self.cells[i]),
                                        p50s[i], i))

    def next_action(self) -> Optional[tuple[str, dict]]:
        """``None`` (keep measuring), ``("explore", cell)`` (re-shard to
        the next cell), or ``("commit", cell)`` (final: re-shard there iff
        it differs from the current topology).

        An explore action does not advance the active cell: steps
        published between the fence's mint and the handover's completion
        still ran the old topology and belong to the old cell; the
        supervisor calls ``cell_started()`` once the handover completed."""
        if self.committed is not None or self._abandoned:
            return None
        need = self.config.warmup_steps + self.config.explore_steps
        if len(self._durs[self.active]) < need:
            return None
        if self.active + 1 < len(self.cells):
            return ("explore", dict(self.cells[self.active + 1]))
        best = self._pick_best()
        self.committed = best
        self.active = best
        return ("commit", dict(self.cells[best]))

    def cell_started(self) -> None:
        """The handover to the next explore cell completed: observations
        from here on belong to it. A no-op after the commit."""
        if self.committed is None and self.active + 1 < len(self.cells):
            self.active += 1

    def abandon(self) -> None:
        self._abandoned = True

    def summary(self) -> dict:
        return {
            "cells": [self.cell_stats(i) for i in range(len(self.cells))],
            "chosen": self.committed,
            "chosen_cell": (None if self.committed is None
                            else dict(self.cells[self.committed])),
            "committed": self.committed is not None,
            "abandoned": self._abandoned,
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
