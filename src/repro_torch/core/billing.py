"""Cost models — paper Table 2 pricing, FaaS sub-second billing, Perf/$.

The paper's cost comparison (§6.3.2) hinges on two billing regimes:

* **FaaS**: pay-per-usage, billed per 100 ms *per live worker* — so the
  scale-in auto-tuner converts removed workers into immediate savings.
* **IaaS**: reservation-based hourly VM pricing (the paper "conservatively"
  pro-rates it per second, favouring PyTorch; we do the same).

We keep the paper's exact April-2021 us-east prices so its numbers reproduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


# ---- paper Table 2 (IBM Cloud, us-east, April 2021) -------------------------

FAAS_WORKER_USD_PER_S = 3.4e-5  # Functions, 1 vCPU / 2 GB (0.122 $/h)
FAAS_BILLING_QUANTUM_S = 0.1  # IBM bills per 100 ms
MESSAGING_VM_USD_PER_S = 0.15 / 3600.0  # C1.4x4 hosting RabbitMQ
REDIS_VM_USD_PER_S = 0.17 / 3600.0  # M1.2x16 hosting Redis
PYTORCH_VM_USD_PER_S = 0.2 / 3600.0  # B1.4x8 = four PyTorch workers
PYTORCH_WORKER_USD_PER_S = PYTORCH_VM_USD_PER_S / 4.0  # 0.05 $/h each

@dataclasses.dataclass(frozen=True)
class FaaSBill:
    """Accumulated cost of a serverless training job."""

    worker_seconds: float  # sum over workers of their individual lifetimes
    wall_seconds: float  # job wall-clock (supervisor + VMs are billed on this)
    # one always-on Redis-analogue VM per update-store shard; live runs
    # pass the real shard count (n_redis == FaaSJobConfig.n_brokers)
    n_redis: int = 1

    @property
    def worker_cost(self) -> float:
        # Per-worker lifetimes are rounded up to the billing quantum.
        return self.worker_seconds * FAAS_WORKER_USD_PER_S

    @property
    def infra_cost(self) -> float:
        return self.wall_seconds * (
            MESSAGING_VM_USD_PER_S + self.n_redis * REDIS_VM_USD_PER_S
        )

    @property
    def total(self) -> float:
        return self.worker_cost + self.infra_cost


def faas_worker_seconds(lifetimes_s: Sequence[float]) -> float:
    """Sum of per-worker lifetimes, each rounded up to the 100 ms quantum."""
    q = FAAS_BILLING_QUANTUM_S
    return float(sum(math.ceil(t / q) * q for t in lifetimes_s))


def faas_cost(lifetimes_s: Sequence[float], wall_s: float, n_redis: int = 1) -> FaaSBill:
    return FaaSBill(
        worker_seconds=faas_worker_seconds(lifetimes_s),
        wall_seconds=wall_s,
        n_redis=n_redis,
    )


def multi_job_rollup(
    lifetimes_s: Sequence[float],
    wall_s: float,
    n_redis: int,
    busy_s_by_job: dict,
) -> dict:
    """Attribute one bin-packed fleet's bill to its jobs (DESIGN.md §14.4).

    The fleet pays ONE pooled bill: the quantum-rounded invocation
    lifetimes plus the shared store VMs, billed once on the fleet's wall
    clock. Each job is charged its share by measured busy seconds (the sum
    over its telemetry rows of ``dur_s * p_active``: the worker-seconds
    the job occupied). Returns ``{"bill": FaaSBill, "per_job": {job:
    {busy_s, share, worker_cost, infra_cost, total}}}``; the per-job
    totals sum to the pooled total (shares are normalised over the busy
    seconds; an all-idle fleet splits evenly).
    """
    bill = faas_cost(lifetimes_s, wall_s, n_redis=n_redis)
    busy = {j: max(float(b), 0.0) for j, b in busy_s_by_job.items()}
    denom = sum(busy.values())
    per_job = {}
    for j, b in busy.items():
        share = (b / denom) if denom > 0 else 1.0 / max(len(busy), 1)
        per_job[j] = {
            "busy_s": b,
            "share": share,
            "worker_cost": share * bill.worker_cost,
            "infra_cost": share * bill.infra_cost,
            "total": share * bill.total,
        }
    return {"bill": bill, "per_job": per_job}


def iaas_cost(n_workers: int, wall_s: float) -> float:
    """PyTorch-cluster cost: workers come in VMs of four, billed per second
    (the paper's 'conservative' pro-rating), all alive for the whole job."""
    n_vms = math.ceil(n_workers / 4)
    return n_vms * PYTORCH_VM_USD_PER_S * wall_s


def perf_per_dollar(exec_time_s: float, price_usd: float) -> float:
    """Paper §6.2.2: Perf/$ := 1/exec_time * 1/price. Higher is better."""
    return 1.0 / (max(exec_time_s, 1e-12) * max(price_usd, 1e-12))


# ---- communication cost model (simulator) -----------------------------------
#
# Byte SIZES are not modelled here: they come from the shared wire codec
# (``repro_torch.wire.codec.leaf_nbytes``) — the same formula the live runtime's
# encoder asserts its output against — so the cost model can never charge
# for bytes the runtime wouldn't ship (DESIGN.md §10).


def dense_update_bytes(n_params: int, itemsize: int = 4) -> int:
    """Bytes of a dense full-update exchange (the BSP / all-reduce unit),
    read from the shared wire codec."""
    from repro_torch.wire import codec as wire_codec

    return int(wire_codec.leaf_nbytes("dense", n_params, n_params, itemsize))


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Latency/bandwidth model of the indirect-communication substrate.

    Defaults approximate the paper's measured environment: Redis round trips
    of a few hundred microseconds at ~1 Gbps NICs, object-store minibatch
    fetches of tens of milliseconds. The *serverful* baseline instead uses a
    ring all-reduce over the same NICs (Gloo), whose per-step time for an
    n-float model across P workers is 2(P-1)/P * n*4 bytes / bw + latency.
    """

    redis_rtt_s: float = 1.0e-3  # per push/pull round trip
    redis_bw_Bps: float = 125e6  # 1 Gbps
    cos_fetch_s: float = 30e-3  # minibatch fetch from object storage
    ring_latency_s: float = 0.5e-3
    ring_bw_Bps: float = 125e6

    def indirect_exchange_time(self, bytes_out: float, n_workers: int,
                               n_redis: int = 1) -> float:
        """Push own update + pull (P-1) peers' updates through Redis shards.

        Per the paper's scalability analysis the strain scales with
        P * bytes / shards; each worker performs one push and P-1 pulls, each
        paying one RTT, pipelined 4-wide (the MLLess client batches pulls).
        """
        p = max(n_workers, 1)
        wire = bytes_out * p / (self.redis_bw_Bps * max(n_redis, 1))
        rtts = (1 + (p - 1) / 4.0) * self.redis_rtt_s
        return wire + rtts

    def allreduce_time(self, dense_bytes: float, n_workers: int) -> float:
        """Serverful ring all-reduce (the PyTorch/Gloo baseline)."""
        p = max(n_workers, 1)
        if p == 1:
            return 0.0
        wire = 2.0 * (p - 1) / p * dense_bytes / self.ring_bw_Bps
        return wire + 2.0 * (p - 1) * self.ring_latency_s
