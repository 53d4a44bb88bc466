"""Where a chunked worker step's decode time goes on one card.

Under retunes and topology tuning the CLI cuts a PMF job's leaves into
64 KiB chunks, and a worker's decode then copies each chunk's mask to the
card, and its values when it has any, and launches B5 once a chunk a
peer: at ML-10M width with 4 workers, 306 launches and 306 to 612 copies
a step. This probe times that decode ``--steps`` times in one process
and in ``--workers`` processes on the same card, each step started
together behind a barrier (as the ISP barrier releases the workers'
decodes), at three densities, and at the middle one with the copies
alone. Then it runs the CLI job alone, one tcp shard and no handover,
``--job-steps`` steps, with chunked leaves decoded on the card, chunked
leaves decoded by the plain codec, and whole leaves, and prints each
step's seconds, its decode phase's and its sent fraction, with the card's
clocks, power, load and throttle reasons sampled every 0.5 s meanwhile.

    python -m repro_torch.launch.decode_probe [--steps 40] [--job-steps 48]

Needs a CUDA card. Prints one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# ML-10M's widths (rank 20), as chip_smoke.py's PMF legs run them
ML10M = {"n_users": 10681, "n_movies": 71567, "n_ratings": 400000,
         "rank": 20, "batch_size": 256}
SPLIT_BYTES = 65536  # the CLI's chunk under retunes and tuning
# no significant value, about the PMF legs' mean sent fraction, and about
# the fraction late in a 48-step job (every chunk then holds some)
DENSITIES = (0.0, 4e-5, 4e-4)
CLOCK_FIELDS = ("clocks.sm,clocks.mem,power.draw,pstate,utilization.gpu,"
                "clocks_throttle_reasons.active")


def _encoded_chunks(seed: int, density: float) -> list:
    """One worker's update at ML-10M width with ``density`` of it
    significant, cut into the CLI's chunks and bitmap-encoded: ``(meta,
    blob)`` a chunk."""
    import torch

    from repro_torch.runtime import sharding
    from repro_torch.wire import codec

    rng = np.random.default_rng(seed)
    tmpl = {"U": torch.empty((ML10M["n_users"], ML10M["rank"]),
                             device="meta"),
            "M": torch.empty((ML10M["rank"], ML10M["n_movies"]),
                             device="meta")}
    out = []
    for leaf, sub, off, n in sharding.tree_subleaves(tmpl, SPLIT_BYTES):
        x = np.zeros(n, np.float32)
        hit = rng.random(n) < density
        x[hit] = rng.standard_normal(int(hit.sum())).astype(np.float32)
        m, parts, _ = codec.encode_leaf(x, scheme="bitmap", key=sub)
        m["k"], m["o"] = leaf, off
        out.append((m, b"".join(bytes(p) for p in parts)))
    return out


def _decode_steps(rank, barrier, density, copies_only, steps, peers,
                  q) -> None:
    """``steps`` decodes of ``peers`` peers' chunks, as a worker's decode
    phase makes them; puts each step's seconds on ``q``."""
    import torch

    from repro_torch.runtime import sharding
    from repro_torch.wire import codec

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)  # the context, outside the timing
    chunks = _encoded_chunks(rank, density)
    leaf_like = {"U": ((ML10M["n_users"], ML10M["rank"]), torch.float32),
                 "M": ((ML10M["rank"], ML10M["n_movies"]), torch.float32)}
    rows = []
    for _ in range(steps):
        barrier.wait()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        bufs = sharding.LeafBuffers(leaf_like, dev)
        for _peer in range(peers):
            for m, blob in chunks:
                if copies_only:
                    codec._upload_bitmap(m, memoryview(blob), dev)
                else:
                    bufs.add_encoded(m, memoryview(blob), impl="cuda")
        torch.cuda.synchronize(dev)
        rows.append(time.perf_counter() - t0)
    q.put((rank, rows))


def decode_contention(processes: int, density: float, copies_only: bool,
                      steps: int, peers: int) -> dict:
    """Each process's decode seconds a step, ``processes`` on one card."""
    ctx = mp.get_context("spawn")
    barrier, q = ctx.Barrier(processes), ctx.Queue()
    procs = [ctx.Process(target=_decode_steps,
                         args=(r, barrier, density, copies_only, steps,
                               peers, q))
             for r in range(processes)]
    for p in procs:
        p.start()
    try:
        rows = dict(q.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    chunks = _encoded_chunks(0, density)
    return {"processes": processes, "density": density,
            "copies_only": copies_only, "peers": peers,
            "chunks": len(chunks),
            "chunks_with_values": sum(int(m["nnz"]) > 0 for m, _ in chunks),
            "median_s": [float(np.median(rows[r][1:])) for r in sorted(rows)],
            "step_s": [[round(x, 5) for x in rows[r]] for r in sorted(rows)]}


def fixed_job(run_dir: str, steps: int, split_bytes: int, impl: str,
              workers: int) -> dict:
    """The CLI's PMF job at ML-10M width alone, one tcp shard, one
    invocation: each step's seconds and decode seconds."""
    out = os.path.join(run_dir, "result.json")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--runtime",
           "faas", "--workload", "pmf", "--workload-cfg", json.dumps(ML10M),
           "--workers", str(workers), "--steps", str(steps),
           "--invocation-steps", str(steps), "--optimizer", "nesterov",
           "--lr", "0.08", "--wire-scheme", "bitmap", "--wire-impl", impl,
           "--n-brokers", "1", "--transport", "tcp", "--device", "cuda",
           "--shard-split-bytes", str(split_bytes), "--run-dir", run_dir,
           "--out", out]
    # the card's clocks, power and load every 0.5 s while the job runs
    smi = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={CLOCK_FIELDS}",
         "--format=csv,noheader,nounits", "-lms", "500"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=600)
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
    if proc.returncode:
        raise SystemExit(f"job failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    with open(out) as f:
        hist = json.load(f)["history"]
    return {"split_bytes": split_bytes, "wire_impl": impl,
            "step_s": [round(r["dur_s"], 5) for r in hist],
            "decode_s": [round(r["phase"]["decode"], 5) for r in hist],
            "sent_fraction": [r["sent_fraction"] for r in hist],
            "card": [dict(zip(CLOCK_FIELDS.split(","),
                              (v.strip() for v in line.split(","))))
                     for line in samples.splitlines() if line.strip()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--job-steps", type=int, default=48)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_probe: needs a CUDA card")
    from repro_torch.kernels import build

    build.build_all()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for procs in (1, args.workers):
        for density, copies_only in ([(d, False) for d in DENSITIES]
                                     + [(DENSITIES[1], True)]):
            print(json.dumps({"decode": decode_contention(
                procs, density, copies_only, args.steps,
                args.workers - 1)}), flush=True)
    with tempfile.TemporaryDirectory(prefix="decode_probe_") as tmp:
        for split, impl in ((SPLIT_BYTES, "cuda"), (SPLIT_BYTES, "numpy"),
                            (0, "cuda")):
            d = os.path.join(tmp, f"job_{split}_{impl}")
            print(json.dumps({"job": fixed_job(
                d, args.job_steps, split, impl, args.workers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
