"""Training driver (port of ``repro.launch.train``).

Two runtimes, as in the JAX package:

* ``inproc`` (the default): the in-process trainer of an LM from the zoo
  with its exchange mode, every mode of the JAX package:

  - ``bsp`` (the default): one gradient over the global batch, clipped,
    and the optimizer's update applied. Under Adam the update is B3 on
    every leaf.
  - ``isp``: the same gradient, the update accumulated into one residual
    and only its significant part applied (the error-feedback filter).
    Under Adam update and filter are B2 on every leaf; under SGD and
    Nesterov the filter is B1. On the card B6 counts each leaf's hits.
  - ``isp-pod``: per-pod divergent optimizer state and residuals over a
    leading pod dimension, one error-feedback ISP exchange per step
    (``dist.compression``) and the auto-tuner's pod scale-in
    (``dist.elastic``); on the card B1 on every leaf's split and B6 on
    every leaf's hit count: JAX's ``fused=True`` exchange.

  Every step runs B7 in each attention forward on the card.

      python -m repro_torch.launch.train --arch lm-100m --mode isp \\
          --workers 4 --per-worker-batch 4 --seq 256 --steps 10
      python -m repro_torch.launch.train --arch lm-100m --mode isp-pod \\
          --workers 4 --per-worker-batch 4 --seq 256 --steps 10 \\
          --scheme bitmap
      python -m repro_torch.launch.train --arch lm-8m --steps 4 \\
          --workers 2 --seq 32 --device cpu

* ``faas``: one MLLess job on the multi-process FaaS runtime
  (``repro_torch.runtime``).

      python -m repro_torch.launch.train --runtime faas --workload pmf \\
          --workload-cfg '{"n_users":10681,"n_movies":71567,"rank":20}' \\
          --optimizer nesterov --lr 0.08 \\
          --workers 4 --steps 10 --invocation-steps 5 --device cuda
      python -m repro_torch.launch.train --runtime faas --workload lr \\
          --workload-cfg '{"n_samples":200000}' --optimizer adam --lr 0.01

  ``--consistency ssp --slack S`` runs bounded staleness in place of the
  per-step ISP barrier, and ``--transport shm`` moves the workers' data
  path onto shared-memory rings; alone or together. ``--chaos SEED:auto``
  or ``--chaos 'SEED:[{"kind": "worker_kill", "step": 4, "worker": 1},
  ...]'`` runs the job under a seeded fault plan (``runtime/faults.py``;
  a plan with a ``supervisor_kill`` runs the supervisor out of process
  through ``faults.run_job_resilient``), ``--prewarm`` spawns each next
  invocation ahead of its boundary, and ``--hostperf`` launches the
  workers under ``launch/hostperf.py``'s environment.
  ``--retune '3:{"n_brokers": 2, "transport": "shm"}'`` (repeatable)
  re-shards the update store live when the frontier reaches step 3, and
  ``--topology-tune`` lets the online co-tuner pick the shard count and
  transport (DESIGN.md §16); both chunk the leaves at 64 KiB over the
  consistent-hash ring unless ``--shard-split-bytes`` says otherwise.

Both run on ``--device`` (default ``cuda``; ``cpu`` only when asked for)
and print their result as JSON. The JAX driver's fleet scheduling
(``--jobs``) is not yet ported and raises.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import optim
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store as ckpt
from repro_torch.configs import ARCH_NAMES, get_arch, get_smoke
from repro_torch.core.autotuner import AutoTunerConfig, ScaleInAutoTuner
from repro_torch.core.billing import faas_cost
from repro_torch.core.isp import ISPConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import elastic as dist_elastic
from repro_torch.dist.compression import (CompressionConfig, apply_combined,
                                          isp_compressed_step)
from repro_torch.kernels import build, ops
from repro_torch.models.config import (ArchConfig, BlockSpec, FF, Mixer,
                                       uniform_groups)
from repro_torch.models.transformer import LM
from repro_torch.optim import apply_updates, clip_by_global_norm

PyTree = Any

# the JAX package's "~100M model": 12L x d768 SwiGLU, 32k vocab (tied)
LM_100M = ArchConfig(
    name="lm-100m",
    family="dense",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32_768,
    groups=uniform_groups(BlockSpec(Mixer.GLOBAL_ATTN, FF.SWIGLU), 12),
    max_seq_len=8192,
    sub_quadratic=False,
)

LM_8M = dataclasses.replace(
    LM_100M, name="lm-8m", d_model=256, n_heads=8, n_kv_heads=8, d_ff=512,
    vocab_size=8192,
    groups=uniform_groups(BlockSpec(Mixer.GLOBAL_ATTN, FF.SWIGLU), 4),
)

_EXTRA = {"lm-100m": LM_100M, "lm-8m": LM_8M}


def resolve_arch(name: str, smoke: bool) -> ArchConfig:
    if name in _EXTRA:
        return _EXTRA[name]
    return get_smoke(name) if smoke else get_arch(name)


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: Any
    residual: PyTree  # ISP error-feedback residual
    step: int
    pool: int  # current worker count (elastic weak scaling)


def _value_and_grad(lm: LM, params: PyTree, batch: dict):
    """``(loss, grads)`` of ``lm.train_loss`` at ``params`` (the JAX
    package's ``jax.value_and_grad``); the loss comes back detached."""
    leaves = [x.detach().requires_grad_() for x in tree_lib.leaves(params)]
    loss, _ = lm.train_loss(tree_lib.unflatten(params, leaves), batch)
    grads = tree_lib.unflatten(params,
                               list(torch.autograd.grad(loss, leaves)))
    return loss.detach(), grads


def make_step(lm: LM, optimizer, isp: ISPConfig | None, clip: float = 1.0):
    """One train step of the ``bsp`` (``isp`` None) or ``isp`` mode (the
    JAX package's ``make_step``).

    The gradient of ``lm.train_loss`` over the whole batch, clipped by its
    global norm; then the optimizer. BSP applies its update. ISP
    accumulates it into the residual, splits the sum at ``v_t`` and applies
    only the significant part (the residual stays local). Under Adam both
    go through the fused kernels (``ops.adam_tree``: B3; ``ops.
    adam_isp_tree``: B2 with the split); under SGD and Nesterov through
    ``optimizer.update`` and, for ISP, B1 (``ops.significance_tree``).

    ``step_fn(params, opt_state, residual, batch, opt_step)`` takes
    ``opt_step``, the host value of ``opt_state.step`` before the update,
    so the threshold and the kernels' scalars need no read from the card:
    the JAX step takes ``v_t`` at the updated step, ``opt_step + 1``.
    Returns ``(params, opt_state, residual, loss, sent_fraction)``, the
    last two as 0-d device tensors (1.0 under BSP).
    """
    fused = optimizer.name == "adam"

    def step_fn(params, opt_state, residual, batch, opt_step: int):
        loss, grads = _value_and_grad(lm, params, batch)
        if clip:
            grads = clip_by_global_norm(grads, clip)
        if isp is None:
            if fused:
                params, opt_state = ops.adam_tree(
                    grads, opt_state, params, optimizer.hparams, opt_step)
            else:
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = apply_updates(params, updates)
            sent = torch.ones((), dtype=torch.float32, device=loss.device)
            return params, opt_state, residual, loss, sent
        v_t = isp.threshold(opt_step + 1)
        if fused:
            _, sig, residual, opt_state = ops.adam_isp_tree(
                grads, opt_state, params, residual, optimizer.hparams,
                opt_step, v_t, 1.0, isp.absolute_floor)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            sig, residual = ops.significance_tree(updates, params, residual,
                                                  v_t, isp.absolute_floor)
        params = apply_updates(params, sig)
        return params, opt_state, residual, loss, ops.sent_fraction(sig)

    return step_fn


def lift_pod(tree: PyTree, n_pods: int) -> PyTree:
    """Stack a shared tree into per-pod state: every leaf gains a leading
    (n_pods,) dim (the divergent moments and residuals of the pod path)."""
    return tree_lib.tree_map(
        lambda x: x[None].repeat((n_pods,) + (1,) * x.dim()), tree)


def _stack(trees: list) -> PyTree:
    """Per-pod trees of one structure -> one tree of (P, ...) leaves."""
    cols = zip(*(tree_lib.leaves(t) for t in trees))
    return tree_lib.unflatten(trees[0], [torch.stack(c) for c in cols])


def make_pod_step(lm: LM, optimizer, isp: ISPConfig, comp: CompressionConfig,
                  n_pods: int, clip: float = 1.0):
    """One ISP-pod train step for a fixed pool size (the JAX package's
    ``make_pod_step``).

    The global batch arrives as (P*B, ...) and is split so dim 0 is the
    pod axis; each pod takes the gradient of ``lm.train_loss`` on its
    shard at the shared parameters, clips it and runs its own optimizer on
    its slice of the lifted state (divergent moments); then one
    error-feedback compressed exchange (``isp_compressed_step``) combines
    the significant parts into the shared parameters. Where JAX ``vmap``s
    the pods, this loops over them.

    ``step_fn(params, opt_pod, res_pod, batch, opt_step)`` takes
    ``opt_step``, the host value of ``opt_pod.step[0]`` before the update,
    so the threshold needs no read from the card: the JAX step takes
    ``v_t`` at the updated step, ``opt_step + 1``. Returns ``(params,
    opt_pod, res_pod, mean loss, sent_fraction)``, the last two as 0-d
    device tensors.
    """

    def step_fn(params, opt_pod, res_pod, batch, opt_step: int):
        shards = {k: v.reshape((n_pods, v.shape[0] // n_pods) + v.shape[1:])
                  for k, v in batch.items()}
        updates, states, losses = [], [], []
        for p in range(n_pods):
            loss, grads = _value_and_grad(
                lm, params, {k: v[p] for k, v in shards.items()})
            if clip:
                grads = clip_by_global_norm(grads, clip)
            state_p = tree_lib.tree_map(lambda x: x[p], opt_pod)
            u, state_p = optimizer.update(grads, state_p, params)
            updates.append(u)
            states.append(state_p)
            losses.append(loss)
        opt_pod = _stack(states)
        v_t = isp.threshold(opt_step + 1)
        combined, res_pod, stats = isp_compressed_step(
            comp, _stack(updates), params, res_pod, v_t,
            floor=isp.absolute_floor)
        params = apply_combined(params, combined)
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        mean = total / torch.full((), float(n_pods), dtype=torch.float32,
                                  device=total.device)
        return params, opt_pod, res_pod, mean, stats["sent_fraction"]

    return step_fn


# -- mode registry ------------------------------------------------------------
#
# A mode owns how a train step is built for a pool size and what a scale-in
# transition does to the train state (the JAX package's registry).


@dataclasses.dataclass(frozen=True)
class TrainMode:
    """One in-process exchange mode."""

    name: str
    pod: bool  # per-pod (lifted) optimizer/residual state
    build_step: Any  # (lm, optimizer, isp, comp, pool) -> step_fn
    scale_in: Any  # (args, st, plan, isp) -> TrainState (pool shrunk by 1)


MODES: dict[str, TrainMode] = {}


def register_mode(mode: TrainMode) -> TrainMode:
    MODES[mode.name] = mode
    return mode


def _device_count(device: torch.device) -> int:
    """The devices a restore could spread over: the CUDA cards, or the one
    CPU (``jax.device_count()`` on a CPU backend)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _scale_in_flat(args, st: TrainState, plan, isp) -> TrainState:
    """bsp/isp scale-in: flush the ISP residual into the params (the
    paper's leaving-worker model averaging, error-feedback form: no update
    mass is lost) with ``apply_updates`` in each leaf's dtype, zero it,
    checkpoint, shrink the pool."""
    if isp is not None:
        st.params = apply_updates(st.params, st.residual)
        st.residual = tree_lib.tree_map(torch.zeros_like, st.residual)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, st)
    st.pool -= 1
    return st


def _scale_in_pod(args, st: TrainState, plan, isp) -> TrainState:
    """isp-pod scale-in: the evicted pod's residual is flushed into the
    shared params and its optimizer/residual slices dropped
    (``dist.elastic``); with a checkpoint directory the transition is
    checkpointed and, when the new pool's mesh fits the devices, restored
    from that checkpoint, as in the JAX package."""
    tr = dist_elastic.plan_transition(plan, st.pool, st.pool - 1)
    st.params, st.opt_state, st.residual = dist_elastic.apply_transition(
        tr, st.params, st.opt_state, st.residual)
    st.pool = tr.new_pods
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, st)
        device = tree_lib.leaves(st.params)[0].device
        if _device_count(device) >= math.prod(tr.new_mesh_shape):
            tree = {"params": st.params, "opt": st.opt_state,
                    "residual": st.residual}
            out = dist_elastic.resharded_restore(
                args.checkpoint_dir, st.step, tree, tr.new_pods)
            st.params = out["params"]
            st.opt_state = out["opt"]
            st.residual = out["residual"]
    return st


register_mode(TrainMode(
    name="bsp", pod=False,
    build_step=lambda lm, opt, isp, comp, pool: make_step(lm, opt, None),
    scale_in=_scale_in_flat,
))
register_mode(TrainMode(
    name="isp", pod=False,
    build_step=lambda lm, opt, isp, comp, pool: make_step(lm, opt, isp),
    scale_in=_scale_in_flat,
))
register_mode(TrainMode(
    name="isp-pod", pod=True,
    build_step=lambda lm, opt, isp, comp, pool: make_pod_step(
        lm, opt, isp, comp, pool),
    scale_in=_scale_in_pod,
))


def save_checkpoint(d: str, st: TrainState) -> str:
    return ckpt.save(
        d, st.step,
        {"params": st.params, "opt": st.opt_state, "residual": st.residual},
        extra={"pool": st.pool})


def restore_checkpoint(d: str, st: TrainState) -> TrainState:
    step = ckpt.latest_step(d)
    if step is None:
        return st
    device = tree_lib.leaves(st.params)[0].device
    tree = ckpt.restore(
        d, step,
        {"params": st.params, "opt": st.opt_state, "residual": st.residual},
        device)
    extra = ckpt.manifest_extra(d, step)
    return TrainState(params=tree["params"], opt_state=tree["opt"],
                      residual=tree["residual"], step=step,
                      pool=extra.get("pool", st.pool))


def train(args) -> dict:
    """The in-process runtime: ``args`` as the CLI parses them. Returns
    the JAX driver's result keys plus ``device``, ``kernel_launches`` (the
    launches of this run) and, on the card, ``peak_memory_bytes``."""
    mode = MODES[args.mode]
    dev = device_lib.resolve(getattr(args, "device", None))
    cfg = resolve_arch(args.arch, args.smoke)
    lm = LM(cfg)
    optimizer = optim.make(args.optimizer, args.lr)
    pod_mode = mode.pod
    isp = ISPConfig(v=args.isp_v) if args.mode.startswith("isp") else None
    # --wire-scheme overrides the byte-accounting codec; 'auto' is per-leaf
    # data-dependent, so the pod accounting keeps the derived codec
    wire_override = getattr(args, "wire_scheme", None)
    if wire_override == "auto":
        wire_override = None
    comp = CompressionConfig(
        scheme=getattr(args, "scheme", "dense"),
        budget=getattr(args, "budget", 0.01), wire=wire_override,
    ) if pod_mode else None
    launches0 = collections.Counter(build.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    params = lm.init(args.seed, dev)
    n_params = lm.n_params()
    print(f"arch={cfg.name} params={n_params:,} mode={args.mode} "
          f"workers={args.workers} device={dev}", flush=True)

    def fresh_state(pool: int) -> TrainState:
        opt0 = optimizer.init(params)
        res0 = tree_lib.tree_map(torch.zeros_like, params)
        if pod_mode:  # per-pod divergent optimizer moments + residuals
            opt0, res0 = lift_pod(opt0, pool), lift_pod(res0, pool)
        return TrainState(params=params, opt_state=opt0, residual=res0,
                          step=0, pool=pool)

    st = fresh_state(args.workers)
    if args.restore and args.checkpoint_dir:
        step = ckpt.latest_step(args.checkpoint_dir)
        if step is not None and pod_mode:
            # per-pod state shapes depend on the checkpointed pool size
            pool = ckpt.manifest_extra(args.checkpoint_dir, step).get(
                "pool", st.pool)
            st = fresh_state(pool)
        st = restore_checkpoint(args.checkpoint_dir, st)
        print(f"restored step={st.step} pool={st.pool}", flush=True)
    # the step takes the optimizer's step count from the host (one read)
    opt_step0 = int(st.opt_state.step.reshape(-1)[0])
    if opt_step0 != st.step + 1:
        raise ValueError(f"optimizer step {opt_step0} does not follow train "
                         f"step {st.step}")

    plan = dist_elastic.ElasticPlan(
        initial_pods=max(args.workers, st.pool),
        per_pod_batch=args.per_worker_batch)
    tuner = None
    if args.autotune:
        tuner = ScaleInAutoTuner(
            AutoTunerConfig(sched_interval_s=args.sched_interval,
                            delta_s=args.sched_interval / 2, min_workers=1),
            st.pool)

    def build_step(pool: int):
        return mode.build_step(lm, optimizer, isp, comp, pool)

    step_fn = build_step(st.pool)
    history = []
    worker_seconds = 0.0
    t_job0 = time.time()
    while st.step < args.steps:
        # weak scaling (paper §3.2): global batch = pool * per-worker batch
        gb = plan.global_batch(st.pool)
        pipe = TokenPipeline(cfg.vocab_size, args.seq, gb, seed=args.seed)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next_batch(st.step).items()}
        t0 = time.time()
        st.params, st.opt_state, st.residual, loss, sent = step_fn(
            st.params, st.opt_state, st.residual, batch, st.step + 1)
        loss = float(loss)  # the step's one wait for the card
        dt = time.time() - t0
        sent = float(sent)
        worker_seconds += dt * st.pool
        st.step += 1
        history.append({"step": st.step, "loss": loss, "sent_fraction": sent,
                        "pool": st.pool, "step_s": dt})
        if st.step % args.log_every == 0:
            print(f"step {st.step:5d} pool={st.pool:2d} loss={loss:.4f} "
                  f"sent={sent:.3f} {dt*1e3:.0f}ms", flush=True)
        if args.checkpoint_dir and st.step % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_dir, st)
        if tuner is not None:
            tuner.observe(st.step, loss, dt)
            if tuner.decide().remove_worker and st.pool > 1:
                st = mode.scale_in(args, st, plan, isp)
                step_fn = build_step(st.pool)
                print(f"  [autotuner] scale-in -> pool={st.pool} "
                      f"(global batch {plan.global_batch(st.pool)})",
                      flush=True)

    wall = time.time() - t_job0
    bill = faas_cost([worker_seconds], wall,
                     n_redis=getattr(args, "n_brokers", 1))
    launches = collections.Counter(build.LAUNCHES)
    launches.subtract(launches0)
    result = {
        "arch": cfg.name,
        "n_params": n_params,
        "final_loss": history[-1]["loss"] if history else None,
        "steps": st.step,
        "final_pool": st.pool,
        "wall_s": wall,
        "worker_seconds": worker_seconds,
        "mean_sent_fraction": float(
            np.mean([h["sent_fraction"] for h in history]))
        if history else None,
        "faas_cost_usd": bill.total,
        "history": history,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "kernel_launches": {k: v for k, v in launches.items() if v},
    }
    if dev.type == "cuda":
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _parse_retunes(specs) -> tuple:
    """--retune STEP:JSON (repeatable) -> scripted_retunes tuples."""
    out = []
    for s in specs or ():
        step, sep, body = s.partition(":")
        if not sep:
            raise SystemExit(f"--retune {s!r}: expected STEP:JSON")
        try:
            out.append((int(step), json.loads(body)))
        except (ValueError, json.JSONDecodeError) as e:
            raise SystemExit(f"--retune {s!r}: expected STEP:JSON ({e})")
    return tuple(out)


def _topology_args(args) -> dict:
    """The topology flags as FaaSJobConfig fields. A live re-shard moves
    little data only when leaves are chunked, so with tuning or retunes on
    and no --shard-split-bytes the job takes the consistent-hash ring over
    64 KiB chunks; the plain path keeps whole leaves and the greedy
    partitioner."""
    retunes = _parse_retunes(getattr(args, "retune", None))
    topo = bool(getattr(args, "topology_tune", False))
    split = int(getattr(args, "shard_split_bytes", 0) or 0)
    partitioner = "greedy"
    if (topo or retunes) and split == 0:
        split = 65536
        partitioner = "ring"
    return {"topology_tune": topo, "scripted_retunes": retunes,
            "partitioner": partitioner, "shard_split_bytes": split}


def train_faas(args) -> dict:
    """Run the job on the multi-process FaaS runtime."""
    from repro_torch.runtime.faults import parse_chaos_arg, run_job_resilient
    from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

    if args.jobs:
        raise NotImplementedError("--jobs: not yet ported")
    topo = _topology_args(args)
    chaos = None
    if args.chaos:
        chaos = parse_chaos_arg(args.chaos, n_workers=args.workers,
                                n_shards=args.n_brokers,
                                total_steps=args.steps)
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
        hostperf=args.hostperf,
        n_brokers=args.n_brokers,
        transport=args.transport,
        consistency=args.consistency,
        slack=args.slack,
        prewarm=args.prewarm,
        autotune=args.autotune,
        tuner=AutoTunerConfig(
            sched_interval_s=args.sched_interval,
            delta_s=args.sched_interval / 2,
        ),
        seed=args.seed,
        chaos=None if chaos is None else chaos.to_spec(),
        **topo,
    )
    if chaos is not None and any(e.kind == "supervisor_kill"
                                 for e in chaos.events):
        # the supervisor kills itself mid-job: drive it from outside, so
        # it can be executed again against its journal
        result = run_job_resilient(cfg)
    else:
        result = run_job(cfg)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


RUNTIMES = {"inproc": train, "faas": train_faas}


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--runtime", default="inproc", choices=tuple(RUNTIMES),
                    help="execution substrate (see above)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the job computes; cpu only when asked")
    ap.add_argument("--arch", default="lm-8m",
                    choices=tuple(_EXTRA) + ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mode", choices=tuple(sorted(MODES)), default="bsp",
                    help="inproc exchange mode (see above)")
    ap.add_argument("--isp-v", type=float, default=0.7)
    ap.add_argument("--scheme", choices=("dense", "topk", "bitmap"),
                    default="dense",
                    help="isp-pod exchange scheme (dist.compression)")
    ap.add_argument("--budget", type=float, default=0.01,
                    help="topk fraction kept per block")
    ap.add_argument("--wire-scheme", default="auto",
                    choices=("auto", "dense", "sparse", "bitmap"),
                    help="the update codec: the faas workers' encoder and "
                    "the isp-pod byte accounting (auto: derived from "
                    "--scheme there)")
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
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workload", default="pmf")
    ap.add_argument("--workload-cfg", default=None,
                    help="JSON overrides for the workload config")
    ap.add_argument("--invocation-steps", type=int, default=1_000_000)
    ap.add_argument("--n-brokers", type=int, default=1)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "shm"),
                    help="faas: worker<->shard update-path channel: "
                    "persistent loopback TCP or shared-memory rings (same "
                    "accounted bytes)")
    ap.add_argument("--consistency", default="isp", choices=("isp", "ssp"),
                    help="faas: pull-barrier model — 'isp' full per-step "
                    "barrier, 'ssp' bounded staleness (a pull at step t "
                    "waits only for steps <= t - slack - 1)")
    ap.add_argument("--slack", type=int, default=3,
                    help="faas: SSP staleness bound (ignored under isp)")
    ap.add_argument("--shard-split-bytes", type=int, default=0,
                    help="faas: split update-store leaves into chunks of at "
                    "most this many bytes before sharding (0 = whole "
                    "leaves; tuning and retunes default it to 65536 with "
                    "the consistent-hash ring partitioner)")
    ap.add_argument("--topology-tune", action="store_true",
                    help="faas: co-tune the shard count and the transport "
                    "online: explore-then-commit over neighbouring cells "
                    "with live re-sharding at epoch fences (DESIGN.md "
                    "§16); requires --consistency isp and no --prewarm")
    ap.add_argument("--retune", action="append", metavar="STEP:JSON",
                    help="faas: one live re-shard when the frontier "
                    "reaches STEP, e.g. '4:{\"n_brokers\": 2}' "
                    "(repeatable; disables the online tuner)")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--chaos", default=None, metavar="SEED:SPEC",
                    help="faas: seeded fault-injection plan "
                    "(runtime/faults.py): SEED:auto expands the default "
                    "randomized multi-fault schedule, "
                    "SEED:[{\"kind\":...,\"step\":...}] is explicit")
    ap.add_argument("--prewarm", action="store_true",
                    help="faas: spawn each next invocation gated ahead of "
                    "its boundary, so its cold start overlaps the current "
                    "one")
    ap.add_argument("--hostperf", action="store_true",
                    help="faas: spawn workers under the tuned host env "
                    "(launch/hostperf.py)")
    # a JAX-driver option that is not yet ported: accepted, then refused
    ap.add_argument("--jobs", default=None)
    args = ap.parse_args()
    res = RUNTIMES[args.runtime](args)
    slim = {k: v for k, v in res.items() if k != "history"}
    print(json.dumps(slim, indent=1, default=str))


if __name__ == "__main__":
    main()
