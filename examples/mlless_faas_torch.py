"""MLLess on real processes, the port's FaaS runtime quickstart (the
PyTorch port of ``examples/mlless_faas.py``; DESIGN.md §9).

Trains PMF (the paper's headline workload) on the multi-process serverless
runtime: 4 stateless worker processes exchange significance-filtered
updates through the in-memory broker, while the supervisor drives the
scale-in auto-tuner from *live* (loss, step-duration) telemetry and meters
real per-worker lifetimes at the 100 ms FaaS billing quantum.

Unlike ``mlless_pmf.py`` (simulator: modelled wall-clock), everything here
is measured: the step durations are real, the scale-in decisions happen on
a live loss curve, and the bill is computed from actual process lifetimes.

The workers compute on the card (``--device cuda``, the default: B1 for
the significance filter, B4/B5 for the wire codec); ``--device cpu`` runs
the kernels' plain versions on the CPU.

    python examples/mlless_faas_torch.py                      # on the card
    python examples/mlless_faas_torch.py --device cpu         # ~1 min, CPU
    python examples/mlless_faas_torch.py --steps 60 --no-check

Exits non-zero if the run fails its health checks (loss must decrease, the
auto-tuner must perform at least one live scale-in, the bill must come from
measured lifetimes).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.runtime import (  # noqa: E402
    PMF_QUICKSTART_CFG,
    pmf_quickstart_config,
    run_job,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workers compute; cpu only when asked")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=140)
    ap.add_argument("--n-brokers", type=int, default=1,
                    help="update-store shards (one broker process each; "
                    "bills n_redis == n_brokers)")
    ap.add_argument("--transport", default="tcp", choices=("tcp", "shm"),
                    help="worker<->broker update path: loopback TCP or "
                    "zero-copy shared-memory rings (repro_torch.wire.shm)")
    ap.add_argument("--consistency", default="isp", choices=("isp", "ssp"),
                    help="pull-barrier model: full per-step ISP barrier "
                    "(default) or bounded staleness (DESIGN.md §13)")
    ap.add_argument("--slack", type=int, default=3,
                    help="SSP staleness bound (ignored under isp)")
    ap.add_argument("--wire-impl", default="cuda",
                    choices=("numpy", "cuda", "auto"),
                    help="update-codec backend: the fused CUDA encode/"
                    "decode kernels (their plain versions on the CPU), the "
                    "numpy reference (bit-identical bytes), or per-leaf "
                    "auto selection by size")
    ap.add_argument("--hostperf", action="store_true",
                    help="launch workers under the tuned host env "
                    "(launch/hostperf.py: tcmalloc preload when present, "
                    "thread caps)")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the health assertions (exploratory runs)")
    args = ap.parse_args()

    cfg = pmf_quickstart_config(
        run_dir=args.run_dir or tempfile.mkdtemp(prefix="mlless_faas_"),
        n_workers=args.workers,
        total_steps=args.steps,
        n_brokers=args.n_brokers,
        transport=args.transport,
        consistency=args.consistency,
        slack=args.slack,
        wire_impl=args.wire_impl,
        hostperf=args.hostperf,
        device=args.device,
    )
    wc = PMF_QUICKSTART_CFG
    barrier = ("ISP barrier" if cfg.consistency == "isp"
               else f"SSP slack={cfg.slack}")
    print(f"PMF {wc['n_users']}x{wc['n_movies']} rank {wc['rank']}, "
          f"{args.workers} worker processes, {args.steps} steps, "
          f"{cfg.n_brokers} broker shard(s) over {cfg.transport}, "
          f"{barrier}, ISP v={cfg.isp_v}, codec impl {cfg.wire_impl}, "
          f"device {cfg.device}"
          f"{', hostperf' if cfg.hostperf else ''} (run dir {cfg.run_dir})")
    res = run_job(cfg)

    hist = res["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    bill = res["bill"]
    print(f"\nsteps completed      {res['steps']}")
    print(f"loss                 {first:.3f} -> {last:.3f} "
          f"(eval RMSE {res['final_eval']:.3f})")
    print(f"pool                 {res['n_workers']} -> {res['final_pool']} "
          f"({len(res['scale_events'])} live scale-in decisions)")
    for ev in res["scale_events"]:
        print(f"  evicted worker {ev['worker']} at step {ev['evict_step']} "
              f"({ev['reason']}, s_delta={ev['s_delta']})")
    print(f"mean sent fraction   "
          f"{sum(r['sent_fraction'] for r in hist) / len(hist):.3f}")
    print(f"mean step time       {res['measured_step_s'] * 1e3:.1f} ms "
          f"(measured, {res['n_invocations']} invocations)")
    if res.get("phase_s_mean"):
        enc = res["phase_s_mean"].get("encode")
        if enc is not None:
            print(f"mean encode phase    {enc * 1e3:.2f} ms "
                  f"(impl {res['wire_impl']})")
    launches = res["kernel_launches_by_worker"]
    print(f"kernel launches      "
          f"{launches.get('0') or 'none (plain versions on the CPU)'} "
          f"(worker 0)")
    if res.get("hostperf") is not None:
        hp = res["hostperf"]
        print(f"hostperf             tcmalloc={hp['tcmalloc'] or 'absent'}")
    print(f"worker-seconds       {bill['worker_seconds']:.1f} "
          f"(per-lifetime, 100 ms quantum)")
    print(f"FaaS bill            ${bill['total']:.6f} "
          f"(workers ${bill['worker_cost']:.6f} + infra "
          f"${bill['infra_cost']:.6f})")

    if args.no_check:
        return 0
    ok = True
    if not last < first:
        print("FAIL: loss did not decrease"); ok = False
    if not res["scale_events"]:
        print("FAIL: the auto-tuner never scaled in"); ok = False
    if res["final_pool"] >= res["n_workers"]:
        print("FAIL: pool did not shrink"); ok = False
    if not (bill["worker_seconds"] > 0 and res["n_invocations"]
            >= args.workers):
        print("FAIL: bill not computed from measured lifetimes"); ok = False
    if res["invariant_max_err"] != 0.0:
        print("FAIL: ISP conservation invariant violated"); ok = False
    if res["dup_mismatches"]:
        print("FAIL: replay divergence detected"); ok = False
    print("\nhealth checks:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
