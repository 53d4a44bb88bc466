#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device — the card's name and power limit (nvidia-smi);
2. build — every kernel of the main path from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a (all sources at once), ptxas registers and
   spills;
3. bit-exactness — B1 (significance filter), B4 (wire pack) and B5 (wire
   unpack-add) against their plain PyTorch versions on the card, at
   n in {1, 7, 127, 1000003, 213620, 1431340}, with -0.0 and all-zero
   tiles in the inputs; B4 at float32, fp16 and bf16, B5 on float32 and
   int32 targets. Tolerance: bit-identical;
4. main path — ``python -m repro_torch.launch.train --runtime faas`` on the
   PMF job at ML-10M width (U 10681 x 20, M 20 x 71567), 4 workers, 10
   steps, 5 steps per invocation, once with ``--wire-scheme bitmap`` and
   once with ``auto``. The kernel launch counts are read from the workers'
   telemetry of these runs (each worker process starts at 0); a kernel of
   the path launched 0 times fails the run;
5. invariants — the bitmap run's final-params digest must be identical
   with 2 broker shards, on a rerun, and with ``--wire-impl numpy`` (which
   must also give identical wire bytes); a small job on the card must
   agree with the same job on the CPU (final eval RMSE within 1e-3
   relative: the two devices sum in different orders). These five runs go
   side by side: they are checked for bits, not timed;
6. times — each kernel and its plain version at the main path's shapes
   and measured density, with CUDA events, L2 cold (a 64 MiB buffer is
   rewritten before every launch) and warm, beside the bound: the bytes
   the function must move over 3.35 TB/s;
7. step profile — one worker step's device work at ML-10M width under
   torch.profiler: device time per step beside the host time and the main
   path's steady step time (the card's busy share);
8. summary — one ``{"kernels": [...]}`` line, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SIZES = (1, 7, 127, 1000003, 213620, 1431340)
ML10M = {"n_users": 10681, "n_movies": 71567, "n_ratings": 400000,
         "rank": 20, "batch_size": 256}
SMALL = {"n_users": 120, "n_movies": 150, "n_ratings": 6000, "rank": 4,
         "batch_size": 64}
KERNELS = {  # name -> (source, the TPU kernel's pallas_call it replaces)
    "significance_filter": ("src/repro_torch/kernels/csrc/significance.cu",
                            "src/repro/kernels/significance.py:92"),
    "wire_pack": ("src/repro_torch/kernels/csrc/wire_pack.cu",
                  "src/repro/kernels/wire_pack.py:133"),
    "wire_unpack_add": ("src/repro_torch/kernels/csrc/wire_pack.cu",
                        "src/repro/kernels/wire_pack.py:261"),
}


class SmokeFailure(Exception):
    pass


def log(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 3: bit-exactness ----------------------------------------------------


def _bits(t):
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype.is_floating_point:
        return t.view(torch.uint8)
    return t


def _same(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _abs_err(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    d = (a.detach().cpu().to(torch.float64) - b.detach().cpu().to(
        torch.float64)).abs()
    d = torch.nan_to_num(d, nan=0.0)  # NaN == NaN bitwise is checked apart
    return float(d.max())


def _inputs(n: int, seed: int):
    """u, x, r with -0.0 entries and a leading all-zero tile in x and r."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(n) * 0.01).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    r = (rng.standard_normal(n) * 0.01).astype(np.float32)
    u[::5] = -0.0
    x[::7] = 0.0
    x[: min(n, 256)] = 0.0
    r[: min(n, 256)] = -0.0
    return (torch.from_numpy(u), torch.from_numpy(x), torch.from_numpy(r))


def check_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    err = {k: 0.0 for k in KERNELS}
    for i, n in enumerate(SIZES):
        u, x, r = _inputs(n, seed=i)
        v_t = 0.5
        got = significance.significance_filter(u.to(dev), x.to(dev),
                                               r.to(dev), v_t)
        want = ref.significance_ref(u.to(dev), x.to(dev), r.to(dev), v_t)
        for g, w in zip(got, want):
            require(_same(g, w), f"significance_filter differs at n={n}")
            err["significance_filter"] = max(err["significance_filter"],
                                             _abs_err(g, w))
        sig = want[0].clone()
        sig[: min(n, 512)] = 0.0  # all-zero tiles
        sig[512:1024:3] = -0.0
        for vdt in (torch.float32, torch.float16, torch.bfloat16):
            got = wire_pack.wire_pack(sig, vdt)
            want = ref.wire_pack_ref(sig, vdt)
            nnz = int(want[4])
            require(int(got[4]) == nnz, f"wire_pack nnz differs at n={n}")
            for j, (g, w) in enumerate(zip(got, want)):
                if j in (2, 3):  # compacted values/indices: first nnz
                    g, w = g[:nnz], w[:nnz]
                require(_same(g, w),
                        f"wire_pack output {j} differs at n={n} {vdt}")
                err["wire_pack"] = max(err["wire_pack"], _abs_err(g, w))
            tgt = torch.from_numpy(np.random.default_rng(100 + i)
                                   .standard_normal(n).astype(np.float32))
            tgt[::3] = -0.0
            tgt = tgt.to(dev)
            mask, cvals = want[0], want[2][:nnz]
            g = wire_pack.wire_unpack_add(tgt, mask, cvals)
            w = ref.wire_unpack_add_ref(tgt, mask, cvals)
            require(_same(g, w), f"wire_unpack_add differs at n={n} {vdt}")
            err["wire_unpack_add"] = max(err["wire_unpack_add"],
                                         _abs_err(g, w))
        si = (sig * 1000).to(torch.int32)
        got = wire_pack.wire_pack(si, torch.int32)
        want = ref.wire_pack_ref(si, torch.int32)
        nnz = int(want[4])
        for j, (g, w) in enumerate(zip(got, want)):
            if j in (2, 3):
                g, w = g[:nnz], w[:nnz]
            require(_same(g, w), f"wire_pack int32 output {j} at n={n}")
        ti = torch.from_numpy(np.random.default_rng(200 + i).integers(
            -1000, 1000, n, dtype=np.int32)).to(dev)
        g = wire_pack.wire_unpack_add(ti, want[0], want[2][:nnz])
        w = ref.wire_unpack_add_ref(ti, want[0], want[2][:nnz])
        require(_same(g, w), f"wire_unpack_add int32 differs at n={n}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # a fault during a kernel surfaces here
    for k, v in err.items():
        log("kernel-check", kernel=k, max_abs_err=v,
            sizes=",".join(map(str, SIZES)))
    return err


# -- phases 4 and 5: the main path ---------------------------------------------


def _train_cmd(run_dir: str, wcfg: dict, *, workers: int, steps: int,
               inv_steps: int, scheme: str, impl: str = "cuda",
               n_brokers: int = 1, device: str = "cuda") -> list:
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--runtime", "faas", "--workload", "pmf",
            "--workload-cfg", json.dumps(wcfg),
            "--workers", str(workers), "--steps", str(steps),
            "--invocation-steps", str(inv_steps),
            "--optimizer", "nesterov", "--lr", "0.08",
            "--wire-scheme", scheme, "--wire-impl", impl,
            "--n-brokers", str(n_brokers), "--device", device,
            "--checkpoint-every", "100",
            "--run-dir", run_dir, "--out", os.path.join(run_dir, "result.json")]


def run_trains(jobs: list, timeout_s: float = 300.0) -> list:
    """Run training jobs ``(run_dir, wcfg, kwargs)`` side by side through
    the CLI; returns their result dicts. Every process group started here
    is killed if the time limit passes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        for run_dir, wcfg, kw in jobs:
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "stderr.log"), "wb") as err:
                procs.append(subprocess.Popen(
                    _train_cmd(run_dir, wcfg, **kw), env=env,
                    stdout=subprocess.DEVNULL, stderr=err,
                    start_new_session=True))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"train runs timed out after {timeout_s}s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    results = []
    for p, (run_dir, _, _) in zip(procs, jobs):
        if p.returncode != 0:
            with open(os.path.join(run_dir, "stderr.log"), "rb") as f:
                tail = f.read().decode(errors="replace")[-4000:]
            raise SmokeFailure(f"train run {run_dir} failed "
                               f"({p.returncode}):\n{tail}")
        with open(os.path.join(run_dir, "result.json")) as f:
            results.append(json.load(f))
    return results


def steady(res: dict, inv_steps: int) -> dict:
    """Step and phase means over the steps that do not start an invocation
    (those pay the worker's cold start: process, torch import, CUDA
    context, first launches)."""
    rows = [r for r in res["history"] if (r["step"] - 1) % inv_steps]
    phases = {k: sum(r["phase"][k] for r in rows) / len(rows)
              for k in rows[0]["phase"]}
    return {"step_s": sum(r["dur_s"] for r in rows) / len(rows),
            "phase_s": phases, "steps": [r["step"] for r in rows]}


def digest(run_dir: str, wcfg: dict, device: str = "cuda") -> str:
    from repro_torch.runtime.supervisor import FaaSJobConfig, \
        final_params_digest

    return final_params_digest(FaaSJobConfig(
        run_dir=run_dir, workload="pmf", workload_cfg=wcfg, device=device,
        optimizer="nesterov", lr=0.08))


def final_params(run_dir: str, wcfg: dict, device: str):
    from repro_torch.runtime.supervisor import FaaSJobConfig, final_params

    return final_params(FaaSJobConfig(
        run_dir=run_dir, workload="pmf", workload_cfg=wcfg, device=device,
        optimizer="nesterov", lr=0.08))[0]


def main_path(tmp: str) -> dict:
    from repro_torch.kernels import build

    runs = {}
    for scheme in ("bitmap", "auto"):
        d = os.path.join(tmp, f"main_{scheme}")
        build.reset_launches()  # this process; each worker starts at 0
        res, = run_trains([(d, ML10M, dict(workers=4, steps=10,
                                           inv_steps=5, scheme=scheme))])
        launches = res["kernel_launches_by_worker"]
        require(res["steps"] == 10 and res["final_pool"] == 4,
                f"{scheme}: steps={res['steps']} pool={res['final_pool']}")
        require(res["dup_mismatches"] == 0, f"{scheme}: dup mismatches")
        require(sorted(launches) == ["0", "1", "2", "3"],
                f"{scheme}: launch telemetry from workers {sorted(launches)}")
        for name in (("significance_filter", "wire_pack", "wire_unpack_add")
                     if scheme == "bitmap"
                     else ("significance_filter", "wire_pack")):
            for w, counts in launches.items():
                require(counts.get(name, 0) > 0,
                        f"{scheme}: {name} launched 0 times on worker {w}")
        sent = [r["sent_fraction"] for r in res["history"]]
        log("main-path", scheme=scheme, impl="cuda", steps=res["steps"],
            final_loss=res["final_loss"], final_eval=res["final_eval"],
            wire_bytes_total=res["wire_bytes_total"],
            step_s_mean=res["measured_step_s"], wall_s=res["wall_s"],
            sent_fraction_mean=sum(sent) / len(sent),
            phase_s_mean=json.dumps(res["phase_s_mean"]),
            steady=json.dumps(steady(res, 5)),
            launches=json.dumps(launches))
        runs[scheme] = (d, res)
    return runs


def invariants(tmp: str, runs: dict) -> None:
    import torch

    d0, res0 = runs["bitmap"]
    dig0 = digest(d0, ML10M)
    params = final_params(d0, ML10M, "cuda")
    require(tuple(params.U.shape) == (10681, 20)
            and tuple(params.M.shape) == (20, 71567), "final param shapes")
    require(bool(torch.isfinite(params.U).all())
            and bool(torch.isfinite(params.M).all()), "non-finite params")
    # the three invariant runs and the card/CPU reference pair run side by
    # side: they are checked for bits, not timed
    labels = (("n_brokers=2", {"n_brokers": 2}), ("rerun", {}),
              ("wire_impl=numpy", {"impl": "numpy"}))
    jobs = [(os.path.join(tmp, "inv_" + label.replace("=", "_")), ML10M,
             dict(workers=4, steps=10, inv_steps=5, scheme="bitmap", **kw))
            for label, kw in labels]
    jobs += [(os.path.join(tmp, f"ref_{device}"), SMALL,
              dict(workers=2, steps=6, inv_steps=3, scheme="bitmap",
                   device=device)) for device in ("cuda", "cpu")]
    results = run_trains(jobs, timeout_s=400.0)
    for (label, _), (d, _, _), res in zip(labels, jobs, results):
        dig = digest(d, ML10M)
        same_bytes = [r["wire_bytes"] for r in res["history"]] == [
            r["wire_bytes"] for r in res0["history"]]
        log("invariant", against="bitmap n_brokers=1", run=label,
            digest_equal=dig == dig0, wire_bytes_equal=same_bytes,
            dup_mismatches=res["dup_mismatches"])
        require(dig == dig0, f"final-params digest differs: {label}")
        require(same_bytes, f"per-step wire bytes differ: {label}")
        require(res["dup_mismatches"] == 0, f"dup mismatches: {label}")
    evals = {"cuda": results[3]["final_eval"], "cpu": results[4]["final_eval"]}
    rel = abs(evals["cuda"] - evals["cpu"]) / abs(evals["cpu"])
    log("reference", workload="pmf-small", cuda_eval=evals["cuda"],
        cpu_eval=evals["cpu"], rel_diff=rel, tolerance=1e-3)
    require(rel <= 1e-3, f"card and CPU disagree: rel {rel}")


# -- phase 6: times ------------------------------------------------------------


def _time(fn, dev, reps: int, cold: bool, flush) -> float:
    """Mean device milliseconds per call, CUDA events around each call."""
    import torch

    fn()  # warm-up (and first-use build)
    total = 0.0
    for _ in range(reps):
        if cold:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def profile_step(dev, steady_step_s: float, reps: int = 5) -> None:
    """Device time of one worker step's device work (gradient, optimizer,
    B1, B4 encode, B5 decode of three peers, apply) at ML-10M width, under
    torch.profiler, beside the main path's steady step time: the share of
    a worker's step the card is busy. The wire phase is not replayed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim, tree as tree_lib
    from repro_torch.core.isp import ISPConfig
    from repro_torch.kernels.ops import significance_tree
    from repro_torch.runtime import sharding, workload

    torch.use_deterministic_algorithms(True)  # as the worker runs
    wl = workload.build("pmf", ML10M, device=str(dev))
    opt = optim.make("nesterov", 0.08)
    isp = ISPConfig(v=0.7)
    params, state = wl.params0, opt.init(wl.params0)
    residual = tree_lib.tree_map(torch.zeros_like, params)
    assignment = sharding.tree_assignment(params, 1)
    like = {k: (tuple(x.shape), x.dtype) for k, x in
            zip(tree_lib.tree_keys(params), tree_lib.leaves(params))}

    def step(t):
        nonlocal params, state, residual
        _, grads = wl.grad_fn(params, wl.batch(t))
        upd, state = opt.update(grads, state, params)
        u = tree_lib.tree_map(lambda a: a * 0.25, upd)
        sig, residual = significance_tree(u, params, residual,
                                          isp.threshold(t))
        (meta, parts), = sharding.encode_tree_sharded(
            sig, assignment, 1, scheme="bitmap", impl="cuda")[0]
        blob = b"".join(bytes(p) for p in parts)
        sums = sharding.LeafBuffers(like, dev)
        for _ in range(3):  # three peers' parts
            off = 0
            for m in meta:
                sums.add_encoded(m, blob[off:off + m["nbytes"]], impl="cuda")
                off += m["nbytes"]
        params = tree_lib.tree_map(lambda a, b, c: a + b + c, params, u,
                                   tree_lib.unflatten(
                                       params, [sums[k] for k in like]))
        torch.cuda.synchronize(dev)

    for t in range(1, 4):
        step(t)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(4, 4 + reps):
            step(t)
        wall = (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels) / reps
    torch.use_deterministic_algorithms(False)
    if dev_us <= 0:
        log("step-profile", device_ms_per_step="not measured",
            note="the profiler reported no device time")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log("step-profile", device_ms_per_step=dev_us / 1e3,
        host_ms_per_step=wall * 1e3,
        busy_share_of_host_step=dev_us / 1e6 / wall,
        busy_share_of_steady_worker_step=dev_us / 1e6 / steady_step_s,
        kernels=len(kernels),
        top=json.dumps([[e.key, e.self_device_time_total / reps / 1e3]
                        for e in top]))


def time_kernels(dev, density: float) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    n = 1431340  # the M leaf, the main path's largest
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    u, x, r = (t.to(dev) for t in _inputs(n, seed=7))
    rng = np.random.default_rng(11)
    sig_np = np.zeros(n, np.float32)
    hit = rng.random(n) < density
    sig_np[hit] = rng.standard_normal(int(hit.sum())).astype(np.float32)
    sig = torch.from_numpy(sig_np).to(dev)
    nnz = int(hit.sum())
    mask, _, cvals, _, _, _ = ref.wire_pack_ref(sig, torch.float32)
    cvals = cvals[:nnz].contiguous()
    tgt = torch.randn(n, device=dev)
    cases = {
        "significance_filter": (
            lambda: significance.significance_filter(u, x, r, 0.5),
            lambda: ref.significance_ref(u, x, r, 0.5),
            20 * n, 5 * n),
        "wire_pack": (
            lambda: wire_pack.wire_pack(sig, torch.float32),
            lambda: ref.wire_pack_ref(sig, torch.float32),
            # x read; mask, dense values, residual, nnz compacted values
            # and indices, and the count written
            4 * n + (n + 7) // 8 + 4 * n + 4 * n + 8 * nnz + 4, 2 * n),
        "wire_unpack_add": (
            lambda: wire_pack.wire_unpack_add(tgt, mask, cvals),
            lambda: ref.wire_unpack_add_ref(tgt, mask, cvals),
            # target, mask and nnz values read; the sum written
            4 * n + (n + 7) // 8 + 4 * nnz + 4 * n, n),
    }
    out = {}
    for name, (kern, plain, nbytes, flops) in cases.items():
        t_cold = _time(kern, dev, 50, True, flush)
        t_warm = _time(kern, dev, 50, False, flush)
        p_cold = _time(plain, dev, 20, True, flush)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations")
        log("kernel-time", kernel=name, n=n, nnz=nnz, ms=t_cold,
            ms_l2warm=t_warm, plain_ms=p_cold, bound_ms=bound,
            bound_by=bound_by, bytes=nbytes, library_ms=None,
            library_note="no single PyTorch call computes this function")
        out[name] = {"ms": t_cold, "plain_ms": p_cold, "bound_ms": bound,
                     "bound_by": bound_by}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=json.dumps(smi))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = build.build_all()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        libs=",".join(p.name for p in libs.values()))
    for name in build.SOURCES:
        s = build.ptxas_summary(name)
        log("ptxas", source=name, registers=s["registers"],
            spill_store_bytes=s["spill_store_bytes"])
        require(s["spill_store_bytes"] == 0, f"{name}: register spills")

    err = check_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = main_path(tmp)
        invariants(tmp, runs)
    sent = [r["sent_fraction"] for r in runs["bitmap"][1]["history"]]
    times = time_kernels(dev, density=sum(sent) / len(sent))
    profile_step(dev, steady(runs["bitmap"][1], 5)["step_s"])

    launches = {k: 0 for k in KERNELS}
    for counts in runs["bitmap"][1]["kernel_launches_by_worker"].values():
        for k, v in counts.items():
            launches[k] += v
    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": times[name]["ms"],
                     "plain_ms": times[name]["plain_ms"],
                     "bound_ms": times[name]["bound_ms"],
                     "bound_by": times[name]["bound_by"],
                     "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
