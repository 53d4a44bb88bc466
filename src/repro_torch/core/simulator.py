"""Serverless training simulator (port of ``repro.core.simulator``).

Runs P worker replicas at once as one multi-worker step over stacked
leaves (a leading worker axis on the replicas, the optimizer state and the
consistency state), with:

* divergent local replicas and the BSP, SSP or ISP exchange
  (``core.consistency``; ISP's split is B1 on every leaf and its
  communicated share is counted by B6 on every leaf, on the card);
* a timing model: per-step worker time = minibatch fetch + compute (flops
  over the worker's rate, with lognormal straggler jitter) + exchange
  (round trips and wire bytes, ``core.billing.CommModel``);
* FaaS billing per live worker plus the always-on VMs, or IaaS billing;
* the scale-in auto-tuner: an evicted worker goes inert and its replica is
  averaged into the others';
* the serverful (ring all-reduce, IaaS) and PyWren (object-store exchange)
  comparators.

Wall time here is *modelled*, host numpy in float64, carried over from the
JAX package line for line, so the same losses and communicated shares give
the JAX run's wall and cost exactly; the losses come from really training
the model, on ``device`` (default ``cuda``). Where JAX ``vmap``s one
worker's ``grad_fn``, the port takes one worker's ``loss_fn`` and runs
``torch.func.vmap(torch.func.grad_and_value(loss_fn))`` over the stacked
replicas, and ``vmap(optimizer.update)`` over the stacked state (its
``step`` has shape (P,), as JAX's does). On the card a run takes
deterministic algorithms (sorted, not atomic, scatter-adds in the indexing
backward), so two runs agree bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.core import autotuner as autotuner_lib
from repro_torch.core import billing as billing_lib
from repro_torch.core import consistency as cons_lib
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.wire import codec as wire_codec

PyTree = Any


class Platform(enum.Enum):
    MLLESS = "mlless"  # specialized serverless: Redis exchange, FaaS billing
    SERVERFUL = "serverful"  # PyTorch-like: ring all-reduce, IaaS billing
    PYWREN = "pywren"  # non-specialized serverless: COS-mediated exchange


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    n_workers: int
    consistency: cons_lib.ConsistencyConfig = dataclasses.field(
        default_factory=cons_lib.ConsistencyConfig
    )
    platform: Platform = Platform.MLLESS
    comm: billing_lib.CommModel = dataclasses.field(
        default_factory=billing_lib.CommModel
    )
    # compute model: 1 vCPU sustained flops for the Cython/MKL inner loops
    worker_flops_rate: float = 4e9
    straggler_sigma: float = 0.12  # lognormal sigma on per-worker compute time
    # update-store shards (paper: Redis instances); the live runtime's
    # FaaSJobConfig.n_brokers
    n_redis: int = 1
    seed: int = 0
    # sparse models update only touched coordinates; serverful exchanges dense
    sparse_model: bool = False
    # the wire codec the modelled platform ships updates with (the sizing
    # formula the live encoder asserts against)
    wire_scheme: str = "sparse"
    # FaaS invocation cold start, billed per invocation and stalling the
    # pool once per invocation round; 0.0 ignores cold starts
    cold_start_s: float = 0.0
    invocations_per_worker: int = 1
    eval_every: int = 1
    # injected intermittent straggler: worker ``straggler_worker`` takes an
    # extra ``straggler_delay_s`` on every ``straggler_every``-th step
    straggler_worker: Optional[int] = None
    straggler_delay_s: float = 0.0
    straggler_every: int = 1


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    wall_s: float  # modelled wall-clock of this step
    comm_bytes: float
    active_workers: int
    comm_fraction: float  # ISP: fraction of params communicated


@dataclasses.dataclass
class SimResult:
    records: list[StepRecord]
    bill: billing_lib.FaaSBill | None
    iaas_cost: float | None
    total_wall_s: float
    final_loss: float
    converged_at_s: Optional[float]
    converged_at_step: Optional[int]
    worker_lifetimes_s: list[float]
    summary: dict

    @property
    def total_cost(self) -> float:
        if self.bill is not None:
            return self.bill.total
        return float(self.iaas_cost or 0.0)

    def perf_per_dollar(self) -> float:
        t = self.converged_at_s or self.total_wall_s
        return billing_lib.perf_per_dollar(t, self.total_cost)


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """Deterministic algorithms on the card for the body (the worker's
    setting, with the cuBLAS workspace it requires); restored after."""
    if device.type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


class ServerlessSimulator:
    """One training job on a modelled platform.

    Args:
      config: platform/timing configuration.
      loss_fn: ``(params, batch) -> loss`` for ONE worker, written with
        tensor operations ``torch.func`` can transform.
      optimizer: a ``repro_torch.optim.Optimizer``.
      params: initial model parameters (one replica; stacked P times).
      flops_per_sample: compute cost model for one sample's grad+update.
      update_nnz_fn: optional ``(batch_size) -> nnz`` for sparse update
        sizing; defaults to the full parameter count (dense).
      device: where the replicas live and train (default ``cuda``; a
        missing card raises unless ``cpu`` is asked for).
    """

    def __init__(
        self,
        config: SimulatorConfig,
        loss_fn: Callable[[PyTree, Any], torch.Tensor],
        optimizer: Optimizer,
        params: PyTree,
        flops_per_sample: float,
        update_nnz_fn: Optional[Callable[[int], float]] = None,
        device: Optional[Any] = None,
    ):
        self.config = config
        self.device = device_lib.resolve(device)
        P = config.n_workers
        self.n_params = int(sum(x.numel() for x in tree_lib.leaves(params)))
        # every worker starts from the same point (paper §6.1)
        self.replicas = tree_lib.tree_map(
            lambda x: x.to(self.device)[None].repeat((P,) + (1,) * x.dim()),
            params)
        self.opt_state = torch.func.vmap(optimizer.init)(self.replicas)
        self.flops_per_sample = float(flops_per_sample)
        self.update_nnz_fn = update_nnz_fn
        # each model's state only under that model (JAX allocates both; the
        # other one is carried through its step unread)
        cc = config.consistency
        self.isp_state = (cons_lib.isp_init(self.replicas, self.device)
                          if cc.model is cons_lib.Model.ISP else None)
        self.ssp_state = (cons_lib.ssp_init(self.replicas, max(cc.slack, 1),
                                            self.device)
                          if cc.model is cons_lib.Model.SSP else None)
        self.active = np.ones(P, dtype=bool)
        self._rng = np.random.default_rng(config.seed)
        self._lifetimes = np.zeros(P, dtype=np.float64)
        self._wall = 0.0
        # SSP pipeline clocks: per-worker finish times, the per-step "all
        # stored" gate, and the pool frontier
        self._ssp_finish = np.zeros(P, dtype=np.float64)
        self._ssp_gate: dict[int, float] = {}
        self._ssp_front = 0.0
        self._grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))
        self._updates = torch.func.vmap(optimizer.update)

    # -- the multi-worker step -------------------------------------------------

    def _multi_worker_step(self, batch_stacked, active_mask: torch.Tensor):
        """One step of every worker; updates the stacked state in place of
        the old and returns (mean loss, communicated share) as 0-d float32
        tensors on the device."""
        cc = self.config.consistency
        grads, losses = self._grads(self.replicas, batch_stacked)
        updates, self.opt_state = self._updates(grads, self.opt_state,
                                                self.replicas)
        amask = active_mask.to(losses.dtype)
        # inert evicted workers: zero update contribution; active workers'
        # updates scaled 1/P_active before the exchange (the exchanged
        # parts sum to the average, paper §3.2)
        p_active = torch.clamp_min(cons_lib.fold(amask), 1.0)
        updates = tree_lib.tree_map(
            lambda u: u * amask.reshape((-1,) + (1,) * (u.dim() - 1))
            / p_active, updates)

        comm_frac = torch.ones((), dtype=torch.float32, device=self.device)
        if cc.model is cons_lib.Model.ISP:
            visible, self.isp_state, sig = cons_lib.isp_split(
                cc.isp, self.isp_state, updates, self.replicas)
            # share of ALL workers' parameters communicated (B6 a leaf)
            comm_frac = ops.sent_fraction(sig)
        elif cc.model is cons_lib.Model.SSP:
            visible, self.ssp_state = cons_lib.ssp_step(self.ssp_state,
                                                        updates)
        else:
            visible = cons_lib.bsp_exchange(updates)

        new = apply_updates(self.replicas, visible)
        # evicted workers' replicas frozen
        self.replicas = tree_lib.tree_map(
            lambda n, o: torch.where(
                active_mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
            new, self.replicas)
        mean_loss = cons_lib.fold(losses * amask) / p_active
        return mean_loss, comm_frac

    # -- timing + billing ------------------------------------------------------

    def _step_times(self, batch_size: int, comm_bytes_per_worker: float,
                    p_active: int, step: int) -> tuple[float, np.ndarray]:
        """Returns (wall_s, per-worker busy seconds) for one step."""
        cfg = self.config
        compute = self.flops_per_sample * batch_size / cfg.worker_flops_rate
        jitter = self._rng.lognormal(0.0, cfg.straggler_sigma, size=p_active)
        per_worker_compute = compute * jitter
        active_ids = np.nonzero(self.active)[0]
        if (
            cfg.straggler_worker is not None
            and step % max(cfg.straggler_every, 1) == 0
        ):
            hit = np.nonzero(active_ids == cfg.straggler_worker)[0]
            per_worker_compute[hit] += cfg.straggler_delay_s
        fetch = cfg.comm.cos_fetch_s
        if cfg.platform is Platform.SERVERFUL:
            comm = cfg.comm.allreduce_time(comm_bytes_per_worker, p_active)
        elif cfg.platform is Platform.PYWREN:
            # COS-mediated exchange: object-store latency per push/pull
            slow = billing_lib.CommModel(
                redis_rtt_s=cfg.comm.cos_fetch_s,
                redis_bw_Bps=cfg.comm.redis_bw_Bps / 2,
                cos_fetch_s=cfg.comm.cos_fetch_s,
            )
            comm = slow.indirect_exchange_time(
                comm_bytes_per_worker, p_active, 1
            )
        else:
            comm = cfg.comm.indirect_exchange_time(
                comm_bytes_per_worker, p_active, cfg.n_redis
            )
        busy = fetch + per_worker_compute + comm
        cc = self.config.consistency
        if cfg.platform is not Platform.MLLESS or cc.model in (
            cons_lib.Model.BSP,
            cons_lib.Model.ISP,
        ):
            wall = float(np.max(busy))  # synchronous barrier
        else:
            # SSP: a worker starts step t once it finished t-1 AND every
            # worker has stored step t-slack-1 (the gate its pull at t
            # waits on); the pool frontier advances at that pipeline's pace
            gate = self._ssp_gate.get(step - cc.slack - 1, 0.0)
            start = np.maximum(self._ssp_finish[active_ids], gate)
            finish = start + busy
            self._ssp_finish[active_ids] = finish
            self._ssp_gate[step] = float(np.max(finish))
            front = float(np.max(self._ssp_finish[active_ids]))
            wall = front - self._ssp_front
            self._ssp_front = front
        return wall, busy

    # -- update sizing ---------------------------------------------------------

    def _bytes_out(self, comm_frac: float, batch_size: int) -> float:
        """Per-worker bytes pushed this step under the platform's encoding,
        from the wire codec's ``leaf_nbytes`` (the whole model sized as one
        float32 leaf with an aggregate nnz, as the JAX simulator does)."""
        cfg = self.config
        if cfg.platform is Platform.SERVERFUL:
            # dense ring all-reduce of the full gradient
            return float(billing_lib.dense_update_bytes(self.n_params))
        nnz = float(self.n_params)
        if cfg.sparse_model and self.update_nnz_fn is not None:
            nnz = float(self.update_nnz_fn(batch_size))
        if cfg.consistency.model is cons_lib.Model.ISP:
            nnz = nnz * max(comm_frac, 0.0)
        if cfg.wire_scheme == wire_codec.AUTO:
            return float(min(
                wire_codec.leaf_nbytes(s, self.n_params, nnz)
                for s in wire_codec.SCHEMES
            ))
        return float(
            wire_codec.leaf_nbytes(cfg.wire_scheme, self.n_params, nnz)
        )

    # -- the run loop -----------------------------------------------------------

    def run(
        self,
        batch_fn: Callable[[int, int], Any],
        batch_size: int,
        max_steps: int,
        loss_threshold: Optional[float] = None,
        eval_fn: Optional[Callable[[PyTree], float]] = None,
        tuner: Optional[autotuner_lib.ScaleInAutoTuner] = None,
    ) -> SimResult:
        """Run until convergence or max_steps.

        Args:
          batch_fn: ``(step, n_workers) -> batch tree stacked (P, B, ...)``
            on the simulator's device. Always called with the FULL P
            (evicted workers' slices are inert).
          batch_size: per-worker minibatch size B (weak scaling: fixed).
          loss_threshold: stop when eval loss <= threshold.
          eval_fn: replica -> scalar eval loss; defaults to training loss.
          tuner: optional scale-in auto-tuner (MLLess platform only).
        """
        cfg = self.config
        P = cfg.n_workers
        records: list[StepRecord] = []
        converged_at = None
        converged_step = None
        # invocation boundaries fall every steps_per_inv steps; a worker
        # bills only the cold starts of invocations it began
        steps_per_inv = max(
            -(-max_steps // max(cfg.invocations_per_worker, 1)), 1
        )
        active_steps = np.zeros(P, dtype=np.int64)

        with _deterministic(self.device):
            for step in range(1, max_steps + 1):
                batch = batch_fn(step, P)
                mask = torch.from_numpy(self.active).to(self.device)
                loss, comm_frac = torch.stack(
                    self._multi_worker_step(batch, mask)).tolist()
                p_active = int(self.active.sum())
                bytes_out = self._bytes_out(comm_frac, batch_size)
                wall, busy = self._step_times(batch_size, bytes_out,
                                              p_active, step)
                self._wall += wall
                self._lifetimes[self.active] += busy
                active_steps[self.active] += 1

                eval_loss = loss
                if eval_fn is not None and step % cfg.eval_every == 0:
                    replica0 = tree_lib.tree_map(lambda x: x[0],
                                                 self.replicas)
                    eval_loss = float(eval_fn(replica0))

                records.append(
                    StepRecord(step, eval_loss, wall, bytes_out * p_active,
                               p_active, comm_frac)
                )

                if tuner is not None and cfg.platform is Platform.MLLESS:
                    tuner.observe(step, eval_loss, wall)
                    decision = tuner.decide()
                    if decision.remove_worker and p_active > 1:
                        self._evict_one()

                if loss_threshold is not None and eval_loss <= loss_threshold:
                    converged_at = self._wall
                    converged_step = step
                    break

        # billing: each invocation a worker began bills its cold start, and
        # each invocation round the pool ran through stalls the barrier once
        inv_per_worker = np.maximum(
            np.ceil(active_steps / steps_per_inv), active_steps > 0
        )
        rounds_executed = int(-(-len(records) // steps_per_inv))
        bill_wall = self._wall + cfg.cold_start_s * rounds_executed
        if cfg.platform is Platform.SERVERFUL:
            bill = None
            iaas = billing_lib.iaas_cost(P, self._wall)
        else:
            bill = billing_lib.faas_cost(
                [
                    t + cfg.cold_start_s * float(k)
                    for t, k in zip(self._lifetimes, inv_per_worker)
                ],
                bill_wall,
                cfg.n_redis,
            )
            iaas = None

        return SimResult(
            records=records,
            bill=bill,
            iaas_cost=iaas,
            total_wall_s=self._wall,
            final_loss=records[-1].loss if records else float("nan"),
            converged_at_s=converged_at,
            converged_at_step=converged_step,
            worker_lifetimes_s=list(self._lifetimes),
            summary={
                "platform": cfg.platform.value,
                "consistency": cfg.consistency.model.value,
                "final_workers": int(self.active.sum()),
            },
        )

    # -- eviction ----------------------------------------------------------------

    def _evict_one(self) -> None:
        """Evict the highest-index active worker; under ISP its replica is
        first averaged into the remaining ones (paper §4.2)."""
        active_ids = np.nonzero(self.active)[0]
        if active_ids.size <= 1:
            return
        evicted = int(active_ids[-1])
        if self.config.consistency.model is cons_lib.Model.ISP:
            new_active = self.active.copy()
            new_active[evicted] = False
            self.replicas = autotuner_lib.evict_and_reintegrate(
                self.replicas, evicted,
                torch.from_numpy(new_active).to(self.device))
            self.active = new_active
        else:
            self.active[evicted] = False
