"""repro_torch.runtime: the multi-process FaaS training runtime (port of
``repro.runtime``, DESIGN.md §9).

    broker      update-store shard: pub/sub, WAL, byte accounting (shard 0
                coordinates: minibatch keys, membership, telemetry)
    sharding    leaf-key -> shard partitioner, sharded tree encoding
    worker      the stateless worker (a subprocess; one thread a job in a
                fleet process)
    supervisor  one job: spawn, evict, respawn, bill, results
    scheduler   the fleet: N jobs bin-packed on ONE pool, one bill
    faults      the chaos plane and the resilient runner
    protocol    the codec and framing the runtime speaks
    workload    the named deterministic workloads (pmf, lr)

Names are imported on first use, so ``python -m
repro_torch.runtime.broker`` imports no torch.
"""

from repro_torch._exports import lazy

_S = "repro_torch.runtime.supervisor"
__getattr__ = lazy(__name__, {
    "FleetConfig": ("repro_torch.runtime.scheduler", "FleetConfig"),
    "FleetScheduler": ("repro_torch.runtime.scheduler", "FleetScheduler"),
    "run_fleet": ("repro_torch.runtime.scheduler", "run_fleet"),
    "FaaSJobConfig": (_S, "FaaSJobConfig"),
    "PMF_QUICKSTART_CFG": (_S, "PMF_QUICKSTART_CFG"),
    "Supervisor": (_S, "Supervisor"),
    "final_params_digest": (_S, "final_params_digest"),
    "pmf_quickstart_config": (_S, "pmf_quickstart_config"),
    "run_job": (_S, "run_job"),
    "WORKLOAD_NAMES": ("repro_torch.runtime.workload", "WORKLOAD_NAMES"),
    "build_workload": ("repro_torch.runtime.workload", "build"),
})
