"""Tuned host-process launch environment for FaaS workers (port of
``repro.launch.hostperf``, DESIGN.md §15.4).

The worker's CPU substrate is part of the measured cost model: a worker
that thrashes the allocator or oversubscribes its math threads inflates
every phase the runtime times. ``build_env`` makes the environment the
supervisor spawns workers with under ``FaaSJobConfig.hostperf``:

* **tcmalloc LD_PRELOAD** when a gperftools library is on the host (the
  distro paths, or ``REPRO_TCMALLOC``); without one the env carries no
  preload and ``describe`` records ``tcmalloc: None``, a stated condition
  of the measurement;
* **thread caps**: OMP / OpenBLAS / MKL / numexpr at ``threads`` (each
  worker is the paper's 1-vCPU function);
* **deterministic cuBLAS workspaces** (``CUBLAS_WORKSPACE_CONFIG``), which
  the worker's ``torch.use_deterministic_algorithms`` needs on the card.

The JAX harness also pins ``XLA_FLAGS``; the port runs no XLA, so it sets
none and ``describe`` reports ``xla_flags: None``.
"""

from __future__ import annotations

import os
from typing import Optional

# distro locations of gperftools' allocator, most specific first; the
# plain .so names cover images that ship only the -dev symlinks
TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
    "/usr/lib64/libtcmalloc_minimal.so.4",
)

# silence tcmalloc's large-alloc reports on multi-GiB arena growth
LARGE_ALLOC_THRESHOLD = "60000000000"

THREAD_ENV_VARS = (
    "OMP_NUM_THREADS",
    "OPENBLAS_NUM_THREADS",
    "MKL_NUM_THREADS",
    "NUMEXPR_NUM_THREADS",
)

# cuBLAS's deterministic workspace setting (torch.use_deterministic_algorithms)
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def find_tcmalloc() -> Optional[str]:
    """First tcmalloc shared object present on this host, or None.
    ``REPRO_TCMALLOC`` overrides the probe (an existing .so forces it, an
    empty string turns the preload off)."""
    override = os.environ.get("REPRO_TCMALLOC")
    if override is not None:
        return override if override and os.path.exists(override) else None
    for path in TCMALLOC_PATHS:
        if os.path.exists(path):
            return path
    return None


def build_env(base: Optional[dict] = None, *, threads: int = 1,
              tcmalloc: bool = True) -> dict:
    """The tuned worker environment on top of ``base`` (a copy). The
    thread caps are set, not defaulted; a found tcmalloc is appended to
    any caller preloads, never replacing them."""
    env = dict(base) if base is not None else dict(os.environ)
    for var in THREAD_ENV_VARS:
        env[var] = str(threads)
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    if tcmalloc:
        lib = find_tcmalloc()
        if lib is not None:
            prior = env.get("LD_PRELOAD", "")
            if lib not in prior.split(":"):
                env["LD_PRELOAD"] = f"{prior}:{lib}".strip(":")
            env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = (
                LARGE_ALLOC_THRESHOLD)
    return env


def describe(env: dict) -> dict:
    """What ``build_env`` applied, carried into the job result so a run
    states its own substrate."""
    preload = env.get("LD_PRELOAD", "")
    return {
        "tcmalloc": next(
            (p for p in preload.split(":") if "tcmalloc" in p), None),
        "xla_flags": None,
        "threads": {var: env.get(var) for var in THREAD_ENV_VARS
                    if var in env},
    }
