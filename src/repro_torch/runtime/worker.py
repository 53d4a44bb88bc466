"""Stateless FaaS worker — one invocation of the MLLess training function
(port of ``repro.runtime.worker``).

Spawned as ``python -m repro_torch.runtime.worker --brokers HOST:PORT[,...]
--worker-id K [--transport shm --shm-seg BASE]`` with no other job state on
the command line: workload, threshold, step budget, consistency, checkpoint
root and device come from the coordinator shard's hello response, and
model / optimizer / residual state is restored from ``checkpoint.store``.
The worker holds one persistent channel per broker shard: a loopback TCP
socket (``tcp``, the default) or the supervisor-allocated shared-memory
ring segment ``<BASE>s<shard>`` (``shm``, DESIGN.md §12) — same framing,
same codec, same accounted bytes.

Per step t, on the job's device (``cuda`` unless the job says ``cpu``):

1. fetch the minibatch key (piggybacked on the previous coordinator pull)
   and load the batch;
2. gradient (autograd) -> optimizer -> ``u_t = update / P_active(t)``;
3. ISP filter ``sig, residual' = split(residual + u_t)``. Under Adam, steps
   2 and 3 after the gradient are one B2 launch per leaf
   (``kernels.ops.adam_isp_tree``); under Nesterov and SGD the optimizer
   runs as tensor code and the filter through B1
   (``kernels.ops.significance_tree``);
4. encode ``sig`` per shard through the codec (B4 under the default
   ``wire_impl='cuda'``); only the wire bytes leave the device;
5. publish, pull the peers' slices, fold them into device-resident
   accumulators (B5 for bitmap leaves) and apply
   ``x += u_t + sum_peers sig`` in a fixed per-element order, so final
   params are bit-exact across shard counts, transports and replays. Under
   ``isp`` the pull at t delivers the peers' step t; under ``ssp`` (bounded
   staleness, DESIGN.md §13) it delivers the frontier step
   ``t - slack - 1`` (nothing while that is below 1), and after the last
   step the worker drains the undelivered tail peers-only and checkpoints
   the drained params at the sentinel step ``total_steps + 1``;
6. on an eviction effective at t: publish ``x + residual`` and exit; on a
   flush from a leaving peer: mean-preserving reintegration, divided by
   the pool just before the step it is delivered at;
7. at a topology fence (DESIGN.md §16, minted by the coordinator and
   carried by every response): checkpoint step fence-1 and exit with
   ``bye:topo-fence``; the supervisor re-shards the store and spawns the
   next invocation into the new topology.

Each step reports its phase times (fetch / compute / encode / wire /
decode) and the kernel launches it made; the SSP drain's launches ride
the final ``bye``. The job's fault plan (``runtime/faults.py``) reaches
the worker in the hello: a ``compute_delay`` (the straggler) sleeps inside
the compute phase, the transport faults act on its RPCs, and a
``ckpt_enospc`` fails one checkpoint write, after which the worker warns
and trains on from the previous generation. On CUDA the worker runs
PyTorch's deterministic algorithms, so the scatter-adds of the PMF
gradient sum in a fixed order and replays stay bit-identical.

With ``--prewarm-gate GATE`` the worker is a pre-warmed successor: after
a warm hello (which leaves the slot's status to the running invocation)
it pays its cold start on a throwaway copy of the initial state (on the
card: the CUDA context, the kernel libraries, and one compute step,
encode, decode and apply, which launch the job's kernels once), resets
the launch counters, writes ``GATE.ready`` and holds until the
supervisor creates ``GATE``. Only then does it say hello for real,
restore the newest checkpoint and train.

Exit codes: 0 clean (done / evicted / invocation boundary), 3 broker
abort, 4 broker unreachable, 5 barrier deadline exceeded.
"""

from __future__ import annotations

import argparse
import errno
import json
import os
import time
from typing import Any, Optional

from repro_torch.runtime.faults import FaultPlan, RetryPolicy, WorkerFaults

PyTree = Any


def _make_rpc(conn, policy_fn):
    """Retrying RPC over one persistent broker-shard connection."""

    def _rpc(header, payload=b"", timeout=None):
        policy: RetryPolicy = policy_fn()
        last: Optional[Exception] = None
        for _ in policy.attempts():
            try:
                return conn.request(
                    header, payload,
                    timeout=timeout if timeout is not None
                    else policy.timeout_s,
                )
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
        raise SystemExit(4) from last

    return _rpc


class _Membership:
    """Worker-side view of the eviction table (worker -> effective step)
    and of the topology fence."""

    def __init__(self, n_workers: int):
        self.P = n_workers
        self.evictions: dict[int, int] = {}
        # topology epoch fence (DESIGN.md §16): once the coordinator mints
        # it, every worker exits at loop top t >= fence so the supervisor
        # can re-shard the store between invocations
        self.topo_fence: Optional[int] = None

    def update(self, resp: dict) -> None:
        for k, v in (resp.get("evictions") or {}).items():
            self.evictions[int(k)] = int(v)
        if resp.get("topo_fence") is not None:
            self.topo_fence = int(resp["topo_fence"])

    def p_active(self, step: int) -> int:
        return self.P - sum(1 for e in self.evictions.values() if e <= step)

    def my_evict_step(self, worker: int) -> Optional[int]:
        return self.evictions.get(worker)


def save_checkpoint(ckpt_dir: str, step: int, state: dict, worker_id: int,
                    wfaults: Optional[WorkerFaults] = None) -> bool:
    """Save one checkpoint generation; False when the write failed. A
    ``ckpt_enospc`` event due at ``step`` fails it after the staged files
    are written and before the atomic install, so the partial snapshot
    stays invisible. A failed save is survivable: the previous generation
    stays restorable and replay covers the gap, so the worker warns and
    trains on."""
    from repro_torch.checkpoint import store as ckpt

    if wfaults is not None and wfaults.ckpt_should_fail(step):
        def _enospc(tmp: str) -> None:
            raise OSError(errno.ENOSPC, "chaos: injected ENOSPC", tmp)

        ckpt.install_write_fault_hook(_enospc)
    try:
        ckpt.save(ckpt_dir, step, state,
                  extra={"worker": worker_id, "next_step": step + 1})
    except OSError as e:
        print(f"worker {worker_id}: checkpoint save at step {step} failed "
              f"({e}); continuing on the previous generation", flush=True)
        return False
    finally:
        ckpt.clear_write_fault_hook()
    return True


def run_worker(addrs: list[tuple[str, int]], worker_id: int,
               transport: str = "tcp", shm_seg: Optional[str] = None,
               prewarm_gate: Optional[str] = None) -> int:
    """One worker's life for one job (solo path). ``shm_seg`` is the base
    name of the supervisor's segments under ``transport='shm'``;
    ``prewarm_gate`` makes it a pre-warmed successor (module docstring)."""
    # the cold start's parts (seconds), printed to the log once the worker
    # is ready to train: the import, the hello, the workload (the CUDA
    # context with it), a successor's warm-up and gate, the restore
    startup: dict = {}
    t_mark = time.monotonic()

    def mark(part: str) -> None:
        nonlocal t_mark
        now = time.monotonic()
        startup[part] = now - t_mark
        t_mark = now

    # torch is imported here so ``--help`` stays instant: the import is
    # part of the measured cold start of each invocation
    import torch

    from repro_torch import optim
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.core import isp as isp_lib
    from repro_torch.dist.elastic import reintegrate_into
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ops import adam_isp_tree, significance_tree
    from repro_torch.runtime import protocol, sharding
    from repro_torch.runtime import workload as workload_lib

    mark("import")
    rpc_policy = RetryPolicy().reseed(worker_id)

    def _policy() -> RetryPolicy:
        return rpc_policy

    n_shards = len(addrs)
    # the transport factory is the only transport-aware line
    conns = [
        protocol.make_transport(
            transport, addr=a,
            shm_name=f"{shm_seg}s{s}" if shm_seg else None,
            timeout=rpc_policy.timeout_s)
        for s, a in enumerate(addrs)
    ]
    rpc0 = _make_rpc(conns[0], _policy)

    def fanout(shard_ids, headers, payloads=None, timeout=None):
        """Pipelined RPC to several shards (send all, then collect all);
        retries whole rounds — every op is idempotent."""
        policy = _policy()
        payloads = payloads or [b""] * len(shard_ids)
        last: Optional[Exception] = None
        for _ in policy.attempts():
            try:
                return protocol.pipelined(
                    [conns[s] for s in shard_ids],
                    list(zip(headers, payloads)),
                    timeout=timeout if timeout is not None
                    else policy.timeout_s,
                )
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
        raise SystemExit(4) from last

    # a warm hello fetches the job without touching the slot's status: the
    # previous invocation still owns it until its bye
    hello, _ = rpc0({"t": "hello", "worker": worker_id,
                     **({"warm": True} if prewarm_gate is not None else {})})
    job = hello["job"]
    mark("hello")
    members = _Membership(int(job["n_workers"]))
    members.update(hello)
    if job.get("rpc"):
        rpc_policy = RetryPolicy.from_dict(job["rpc"]).reseed(worker_id)
    # this worker's slice of the job's fault plan (wire delays, stalls and
    # resets, checkpoint write failures, the straggler's compute delay);
    # with no plan every hook stays dormant
    _plan = FaultPlan.from_spec(job.get("chaos"))
    wfaults = WorkerFaults(_plan, worker_id) if _plan is not None else None
    if wfaults is not None:
        wfaults.install()

    wl = workload_lib.build(job["workload"], job["workload_cfg"],
                            device=job.get("device", "cuda"))
    dev = wl.device
    if dev.type == "cuda":
        # sorted (not atomic) scatter-adds in the PMF backward: bit-identical
        # gradients run to run. The flag is set where
        # torch.use_deterministic_algorithms sets it: that wrapper also
        # imports torch._inductor's config (for a flag no worker reads),
        # seconds of every worker's cold start on the card's host
        torch._C._set_deterministic_algorithms(True)
    else:
        torch.set_num_threads(1)  # one vCPU per function, like the reference
    mark("workload")
    optimizer = optim.make(job["optimizer"], job["lr"])
    fused_adam = optimizer.name == "adam"
    isp = isp_lib.ISPConfig(
        v=float(job["isp_v"]), decay=bool(job.get("isp_decay", True))
    )
    total_steps = int(job["total_steps"])
    invocation_steps = int(job.get("invocation_steps", 1_000_000))
    checkpoint_every = int(job.get("checkpoint_every", 10))
    pull_deadline_s = float(job.get("pull_deadline_s", 120.0))
    wire_scheme = str(job.get("wire_scheme", "auto"))
    wire_quant = str(job.get("wire_quant", "none"))
    wire_impl = str(job.get("wire_impl", "cuda"))
    # bounded staleness (DESIGN.md §13): under 'ssp' a pull at step t is
    # served exactly the peers' updates of step t - slack - 1
    consistency = str(job.get("consistency", "isp"))
    slack = int(job.get("slack", 3))
    ckpt_dir = os.path.join(job["run_dir"], "ckpt", f"w{worker_id:03d}")

    params = wl.params0
    opt_state = optimizer.init(params)
    residual = tree_lib.tree_map(torch.zeros_like, params)

    split_bytes = int(job.get("shard_split_bytes", 0))
    partitioner = str(job.get("partitioner", "greedy"))
    leaf_keys = protocol.tree_keys(params)
    assignment = sharding.tree_assignment(
        params, n_shards, split_bytes=split_bytes, partitioner=partitioner,
    )
    leaf_like = {
        k: (tuple(leaf.shape), leaf.dtype)
        for k, leaf in zip(leaf_keys, tree_lib.leaves(params))
    }

    def compute(params, opt_state, residual, batch, inv_p, t):
        loss, grads = wl.grad_fn(params, batch)
        if fused_adam:
            u, sig, res, opt_state = adam_isp_tree(
                grads, opt_state, params, residual, optimizer.hparams,
                int(opt_state.step), isp.threshold(t), inv_p,
                isp.absolute_floor)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            u = tree_lib.tree_map(lambda a: a * inv_p, updates)
            sig, res = significance_tree(
                u, params, residual, isp.threshold(t), isp.absolute_floor)
        sent = isp_lib.communicated_fraction(sig)
        # conservation witness: sent + residual' - (residual + update)
        inv_err = max(
            float(torch.max(torch.abs((s + r2) - (r0 + uu))))
            for s, r2, r0, uu in zip(
                tree_lib.leaves(sig), tree_lib.leaves(res),
                tree_lib.leaves(residual), tree_lib.leaves(u))
        )
        return u, sig, res, opt_state, float(loss), sent, inv_err

    def save_ckpt(step_done: int) -> None:
        nonlocal last_saved
        if step_done <= 0 or step_done == last_saved:
            return
        if save_checkpoint(
                ckpt_dir, step_done,
                {"params": params, "opt": opt_state, "residual": residual},
                worker_id, wfaults):
            last_saved = step_done

    def bye(reason: str, launches: Optional[dict] = None) -> None:
        if wfaults is not None:
            wfaults.uninstall()  # the farewell RPCs run fault-free
        hdr = {"t": "bye", "worker": worker_id, "reason": reason,
               "wall": time.time()}
        if launches:
            hdr["launches"] = launches
        rpc0(hdr)
        for c in conns:
            c.close()

    def pull_all(step: int):
        """One barrier's worth of pipelined coalesced pulls. Returns
        (exit_code, shard_parts): None on success, 3 abort, 5 deadline."""
        nonlocal key_next
        deadline = time.monotonic() + pull_deadline_s
        shard_parts: list = [None] * n_shards
        pending = list(range(n_shards))
        while pending:
            resps = fanout(
                pending,
                [{"t": "pull", "worker": worker_id, "step": step,
                  "timeout_s": 2.0} for _ in pending],
            )
            nxt = []
            for s, (resp, blob) in zip(pending, resps):
                if resp.get("abort"):
                    return 3, None
                members.update(resp)
                if resp.get("ready"):
                    if s == 0:
                        key_next = resp.get("key_next")
                    shard_parts[s] = (resp["parts"], blob)
                else:
                    nxt.append(s)
            pending = nxt
            if pending and time.monotonic() > deadline:
                return 5, None
        return None, shard_parts

    def decode_parts(shard_parts):
        """Peers' slices and eviction flushes into device accumulators, in
        a per-element order fixed for any shard count."""
        sums = sharding.LeafBuffers(leaf_like, dev)
        flush_acc: dict[int, sharding.LeafBuffers] = {}
        for descs, blob in shard_parts:
            for desc, m, view in sharding.iter_part_views(descs, blob):
                if desc.get("flush"):
                    q = int(desc["worker"])
                    if q not in flush_acc:
                        flush_acc[q] = sharding.LeafBuffers(leaf_like, dev)
                    flush_acc[q].add_encoded(m, view, impl=wire_impl)
                else:
                    sums.add_encoded(m, view, impl=wire_impl)
        peers_sum = tree_lib.unflatten(params, [sums[k] for k in leaf_keys])
        flushes = []
        for q, acc in flush_acc.items():
            acc.assert_complete(what=f"flush from worker {q}")
            flushes.append(
                (q, tree_lib.unflatten(params, [acc[k] for k in leaf_keys])))
        return peers_sum, flushes

    def apply_flushes(params, flushes, deliver_step: int):
        # a 0-d float32 divisor on the card, as the JAX worker divides by
        # jnp.asarray(pool_before, jnp.float32)
        pool_before = torch.full((), float(members.p_active(
            deliver_step - 1)), dtype=torch.float32, device=dev)
        for _q, flushed in sorted(flushes, key=lambda kv: kv[0]):
            params = reintegrate_into(params, flushed, pool_before)
        return params

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def ssp_drain(params):
        """Catch-up merge: the last regular pull (step T) delivered the
        frontier T - slack - 1, so steps T - slack .. T are undelivered.
        Pull them on the same schedule (a pull at td delivers
        td - slack - 1) and apply peers-only, step-ascending — the order a
        peer that saw them live used. Returns (exit_code, params)."""
        for td in range(total_steps + 1, total_steps + slack + 2):
            code, shard_parts = pull_all(td)
            if code is not None:
                return code, params
            peers_sum, flushes = decode_parts(shard_parts)
            params = tree_lib.tree_map(lambda a, c: a + c.to(a.dtype),
                                       params, peers_sum)
            if flushes:
                params = apply_flushes(params, flushes, td - slack - 1)
        sync()
        return None, params

    def launched_since(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in kbuild.LAUNCHES.items()
                if v != before.get(k, 0)}

    if prewarm_gate is not None:
        # pre-warmed respawn: pay the cold start now, under the previous
        # invocation's tail, on a throwaway copy of the initial state (the
        # job's own state is not touched before the gate opens)
        if dev.type == "cuda":
            for name in ("significance", "wire_pack", "fused_adam"):
                kbuild.load(name)
        w_params = tree_lib.tree_map(torch.clone, params)
        w_opt = optimizer.init(w_params)
        w_res = tree_lib.tree_map(torch.zeros_like, w_params)
        w_u, w_sig = compute(w_params, w_opt, w_res, wl.batch(0), 1.0, 1)[:2]
        w_enc, _ = sharding.encode_tree_sharded(
            w_sig, assignment, n_shards, scheme=wire_scheme,
            quant=wire_quant, split_bytes=split_bytes, impl=wire_impl)
        w_peers, _ = decode_parts([
            protocol.pack_parts([({"worker": worker_id, "step": 0,
                                   "meta": meta}, parts)])
            for meta, parts in w_enc])
        tree_lib.tree_map(lambda a, b, c: a + b + c.to(a.dtype),
                          w_params, w_u, w_peers)
        sync()
        kbuild.reset_launches()  # a warm leg reports a cold one's launches
        mark("warm")
        with open(prewarm_gate + ".ready", "w"):
            pass
        while not os.path.exists(prewarm_gate):
            time.sleep(0.02)
        # now this invocation owns the worker's slot: announce for real
        hello2, _ = rpc0({"t": "hello", "worker": worker_id})
        members.update(hello2)
        mark("gate")

    start_step = 1
    last_saved = 0
    latest, restored = ckpt.restore_latest_valid(
        ckpt_dir, {"params": params, "opt": opt_state, "residual": residual},
        device=dev,
    )
    if latest is not None:
        params, opt_state, residual = (
            restored["params"], restored["opt"], restored["residual"])
        start_step = latest + 1
        last_saved = latest
    mark("restore")
    print("startup " + json.dumps(startup), flush=True)

    t = start_step
    steps_this_invocation = 0
    key_next: Optional[int] = None  # piggybacked by the previous pull
    while True:
        if wfaults is not None:
            wfaults.at_step(t)
        ev = members.my_evict_step(worker_id)
        if ev is not None and ev <= total_steps and t >= ev:
            # eviction effective at ev: publish replica + residual (no
            # update mass is lost) and end this worker's life
            flushed = tree_lib.tree_map(lambda x, r: x + r, params, residual)
            per_shard, _ = sharding.encode_tree_sharded(
                flushed, assignment, n_shards,
                quant=wire_quant, impl=wire_impl, split_bytes=split_bytes,
            )
            fanout(
                list(range(n_shards)),
                [{"t": "flush", "worker": worker_id, "step": ev,
                  "meta": meta} for meta, _ in per_shard],
                [parts for _, parts in per_shard],
            )
            bye("evicted")
            return 0
        # topology fence: exit before step fence so the supervisor can
        # migrate the store. After the eviction check on purpose: a granted
        # eviction step is always below the fence, so a leaver's flush
        # still lands in a barrier the survivors complete before it. The
        # fence-1 checkpoint is durable before the handover starts, so the
        # respawned invocation (the new shard count and transport on its
        # command line, the new chunking and partitioner in its hello's
        # job) resumes at the fence and never replays a pre-fence step
        # against the re-sharded store
        if members.topo_fence is not None and t >= members.topo_fence:
            save_ckpt(t - 1)
            bye("topo-fence")
            return 0
        if t > total_steps:
            if consistency == "ssp" and t == total_steps + 1:
                # drain exactly once: the sentinel checkpoint makes a
                # post-drain respawn resume at total_steps + 2 and go
                # straight to bye; a SIGKILL mid-drain restores a step
                # <= total_steps, replays (publishes dup-check identical)
                # and drains again from scratch
                launches0 = dict(kbuild.LAUNCHES)
                code, params = ssp_drain(params)
                if code is not None:
                    # no checkpoint of partly drained params: the respawn
                    # restores a pre-drain step and re-drains (pulls are
                    # read-only, so the replay is exact)
                    return code
                save_ckpt(total_steps + 1)
                bye("done", launched_since(launches0))
            else:
                save_ckpt(t - 1)
                bye("done")
            return 0
        if steps_this_invocation >= invocation_steps:
            save_ckpt(t - 1)
            bye("invocation-end")
            return 0

        tp = time.perf_counter
        launches0 = dict(kbuild.LAUNCHES)
        t0 = tp()
        # -- fetch
        if key_next is None:
            resp, _ = rpc0({"t": "batch", "worker": worker_id, "step": t})
            members.update(resp)
            key = int(resp["key"])
        else:
            key = key_next
        batch = wl.batch(key)
        t_fetch = tp()
        # -- compute: grads -> optimizer -> ISP split (B2, or B1)
        p_act = members.p_active(t)
        u, sig, res, opt_state, loss, sent, inv_err = compute(
            params, opt_state, residual, batch, 1.0 / p_act, t)
        sync()
        if wfaults is not None:
            # the straggler's injected stall, inside the compute phase:
            # the peers' exposure to it is what ISP and SSP price apart
            delay = wfaults.compute_delay_s(t)
            if delay > 0.0:
                time.sleep(delay)
        t_compute = tp()
        # -- encode (B4 under wire_impl='cuda'); quantization error joins
        #    the residual
        per_shard, qerr = sharding.encode_tree_sharded(
            sig, assignment, n_shards,
            scheme=wire_scheme, quant=wire_quant,
            with_residual=(wire_quant != "none"),
            split_bytes=split_bytes, impl=wire_impl,
        )
        if qerr is not None:
            res = tree_lib.tree_map(lambda r, e: r + e.to(r.dtype), res, qerr)
            sync()
        total_bytes = sum(protocol.wire_bytes(meta) for meta, _ in per_shard)
        t_encode = tp()
        # -- wire: one pipelined publish round, then the barrier pulls
        pub_hdrs = []
        for s, (meta, _parts) in enumerate(per_shard):
            hdr = {"t": "publish", "worker": worker_id, "step": t,
                   "meta": meta}
            if s == 0:
                hdr.update(loss=loss, sent_fraction=sent, inv_err=inv_err,
                           wire_bytes=total_bytes)
            pub_hdrs.append(hdr)
        for ack, _ in fanout(list(range(n_shards)), pub_hdrs,
                             [parts for _, parts in per_shard]):
            members.update(ack)
        code, shard_parts = pull_all(t)
        if code is not None:
            return code
        t_wire = tp()
        # -- decode (B5 for bitmap leaves) into device accumulators: the
        #    peers' step t under 'isp', the frontier t - slack - 1 under
        #    'ssp' (no parts, and no launch, while that is below 1)
        peers_sum, flushes = decode_parts(shard_parts)
        sync()
        t_decode = tp()
        # -- apply (counted as compute)
        params = tree_lib.tree_map(lambda a, b, c: a + b + c.to(a.dtype),
                                   params, u, peers_sum)
        if flushes:
            deliver_step = t - slack - 1 if consistency == "ssp" else t
            params = apply_flushes(params, flushes, deliver_step)
        sync()
        residual = res
        t_apply = tp()
        launched = launched_since(launches0)
        report = {
            "t": "report", "worker": worker_id, "step": t,
            "dur_s": float(t_apply - t0),
            "phase": {
                "fetch": t_fetch - t0,
                "compute": (t_compute - t_fetch) + (t_apply - t_decode),
                "encode": t_encode - t_compute,
                "wire": t_wire - t_encode,
                "decode": t_decode - t_wire,
            },
            "launches": launched,
        }
        faults = wfaults.drain() if wfaults is not None else []
        if faults:  # the worker-side faults fired since the last report
            report["faults"] = faults
        rpc0(report)
        steps_this_invocation += 1
        if t % checkpoint_every == 0:
            save_ckpt(t)
        t += 1


def _parse_addrs(spec: str) -> list[tuple[str, int]]:
    out = []
    for item in spec.split(","):
        host, port = item.strip().rsplit(":", 1)
        out.append((host, int(port)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--brokers", required=True,
                    help="comma-separated HOST:PORT per shard "
                    "(shard 0 = coordinator)")
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "shm"),
                    help="update-path channel per shard "
                    "(wire.framing.make_transport); shm needs --shm-seg")
    ap.add_argument("--shm-seg", default=None,
                    help="shared-memory segment base name (supervisor-"
                    "allocated); shard s attaches '<base>s<s>'")
    ap.add_argument("--prewarm-gate", default=None,
                    help="pre-warmed respawn: warm up, touch "
                    "'<gate>.ready', then hold until the gate file "
                    "appears before restoring state and training")
    args = ap.parse_args()
    if args.transport == "shm" and not args.shm_seg:
        ap.error("--transport shm requires --shm-seg")
    raise SystemExit(run_worker(_parse_addrs(args.brokers), args.worker_id,
                                transport=args.transport,
                                shm_seg=args.shm_seg,
                                prewarm_gate=args.prewarm_gate))


if __name__ == "__main__":
    main()
