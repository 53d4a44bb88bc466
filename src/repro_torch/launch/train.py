"""Training driver (port of ``repro.launch.train``, ``--runtime faas``).

    python -m repro_torch.launch.train --runtime faas --workload pmf \\
        --workload-cfg '{"n_users":10681,"n_movies":71567,"rank":20}' \\
        --workers 4 --steps 10 --invocation-steps 5 --device cuda

runs one MLLess training job on the multi-process FaaS runtime
(``repro_torch.runtime``) and prints its result as JSON. The job runs on
``--device`` (default ``cuda``; ``cpu`` only when asked for). The JAX
driver's in-process runtime, fleet scheduling (``--jobs``), chaos plans,
topology tuning and ``--hostperf`` are not yet ported and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def train_faas(args) -> dict:
    """Run the job on the multi-process FaaS runtime."""
    from repro_torch import device as device_lib
    from repro_torch.core.autotuner import AutoTunerConfig
    from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

    for flag in ("jobs", "chaos", "retune", "hostperf", "topology_tune"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: not yet ported")
    device_lib.resolve(args.device)  # no CUDA -> raise before spawning
    run_dir = args.run_dir or args.checkpoint_dir or tempfile.mkdtemp(
        prefix="repro_torch_faas_")
    cfg = FaaSJobConfig(
        run_dir=run_dir,
        workload=args.workload,
        workload_cfg=json.loads(args.workload_cfg) if args.workload_cfg
        else {},
        device=args.device,
        n_workers=args.workers,
        total_steps=args.steps,
        invocation_steps=args.invocation_steps,
        checkpoint_every=args.checkpoint_every,
        optimizer=args.optimizer,
        lr=args.lr,
        isp_v=args.isp_v,
        wire_scheme=args.wire_scheme,
        wire_quant=args.wire_quant,
        wire_impl=args.wire_impl,
        n_brokers=args.n_brokers,
        transport=args.transport,
        consistency=args.consistency,
        shard_split_bytes=args.shard_split_bytes,
        autotune=args.autotune,
        tuner=AutoTunerConfig(
            sched_interval_s=args.sched_interval,
            delta_s=args.sched_interval / 2,
        ),
        seed=args.seed,
    )
    result = run_job(cfg)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runtime", default="faas", choices=("faas", "inproc"),
                    help="execution substrate (inproc: not yet ported)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workers compute; cpu only when asked")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--isp-v", type=float, default=0.7)
    ap.add_argument("--wire-scheme", default="auto",
                    choices=("auto", "dense", "sparse", "bitmap"))
    ap.add_argument("--wire-quant", default="none",
                    choices=("none", "fp16", "bf16"))
    ap.add_argument("--wire-impl", default="cuda",
                    choices=("numpy", "cuda", "auto"),
                    help="codec backend: the fused CUDA kernels (default), "
                    "the numpy reference, or per-leaf auto selection; "
                    "bit-identical bytes")
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "sgd", "nesterov"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--sched-interval", type=float, default=20.0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workload", default="pmf")
    ap.add_argument("--workload-cfg", default=None,
                    help="JSON overrides for the workload config")
    ap.add_argument("--invocation-steps", type=int, default=1_000_000)
    ap.add_argument("--n-brokers", type=int, default=1)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "shm"))
    ap.add_argument("--consistency", default="isp", choices=("isp", "ssp"))
    ap.add_argument("--shard-split-bytes", type=int, default=0)
    ap.add_argument("--run-dir", default=None)
    # JAX-driver options that are not yet ported: accepted, then refused
    ap.add_argument("--hostperf", action="store_true")
    ap.add_argument("--topology-tune", action="store_true")
    ap.add_argument("--chaos", default=None)
    ap.add_argument("--retune", action="append")
    ap.add_argument("--jobs", default=None)
    args = ap.parse_args()
    if args.runtime != "faas":
        raise NotImplementedError(f"--runtime {args.runtime}: not yet ported")
    res = train_faas(args)
    slim = {k: v for k, v in res.items() if k != "history"}
    print(json.dumps(slim, indent=1, default=str))


if __name__ == "__main__":
    main()
