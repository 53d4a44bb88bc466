"""The port's live FaaS runtime on the CPU, held to the JAX runtime.

One small PMF job (2 workers, 6 steps, two invocations each) runs through
``repro_torch`` with ``device="cpu"`` from the JAX package's own initial
parameters, and through ``repro.runtime.run_job``. The two frameworks sum
the minibatch gradient in different orders, so an element near the ISP
threshold can flip its mask and the runs are not bit-identical; the test
holds the final held-out RMSE to 1e-3 relative (a flipped element moves
the RMSE by far less; a wrong step moves it by far more) and prints the
largest parameter differences and both runs' wire bytes. Within the port
the result is bit-identical across broker shard counts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.checkpoint import store as jstore
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import build_workload, run_job as jrun_job

from repro_torch import convert
from repro_torch.runtime import supervisor
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WCFG = {"n_users": 120, "n_movies": 150, "n_ratings": 6000, "rank": 4,
        "batch_size": 64}
JOB = dict(workload="pmf", n_workers=2, total_steps=6, invocation_steps=3,
           checkpoint_every=100, optimizer="nesterov", lr=0.08, isp_v=0.5,
           deadline_s=180.0)


def _params0(tmp_path) -> str:
    jp = build_workload("pmf", WCFG).params0
    return convert.write_params0(str(tmp_path / "params0.npz"), ["U", "M"],
                                 [np.asarray(jp.U), np.asarray(jp.M)])


def _port_cfg(run_dir, params0, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG, params0=params0),
                         **dict(JOB, **kw))


def _jax_final_params(run_dir) -> list[np.ndarray]:
    from repro import optim as joptim

    import jax
    import jax.numpy as jnp

    wl = build_workload("pmf", WCFG)
    like = {"params": wl.params0,
            "opt": joptim.make("nesterov", 0.08).init(wl.params0),
            "residual": jax.tree.map(jnp.zeros_like, wl.params0)}
    d = os.path.join(run_dir, "ckpt", "w000")
    tree = jstore.restore(d, jstore.latest_step(d), like)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree["params"])]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    p0 = _params0(tmp)
    cfg = _port_cfg(tmp / "job", p0)
    return cfg, run_job(cfg), p0, tmp


def test_live_job_tracks_the_jax_runtime(port_run, tmp_path):
    cfg, res, _, _ = port_run
    jres = jrun_job(JFaaSJobConfig(run_dir=str(tmp_path / "jax"),
                                   workload_cfg=dict(WCFG), **JOB))
    params, _ = supervisor.final_params(cfg)
    got = convert.to_leaves(params)
    want = _jax_final_params(str(tmp_path / "jax"))
    absd = max(float(np.max(np.abs(a - b))) for a, b in zip(got, want))
    reld = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
               for a, b in zip(got, want))
    rel_eval = abs(res["final_eval"] - jres["final_eval"]) / jres[
        "final_eval"]
    print(f"final params: max |diff| {absd:.3e}, max rel diff {reld:.3e}; "
          f"final eval port {res['final_eval']:.6f} jax "
          f"{jres['final_eval']:.6f} (rel {rel_eval:.2e}); wire bytes "
          f"port {res['wire_bytes_total']} jax {jres['wire_bytes_total']}")
    assert res["steps"] == jres["steps"] == 6
    assert res["final_pool"] == jres["final_pool"] == 2
    assert res["n_invocations"] == jres["n_invocations"] == 4
    assert res["dup_mismatches"] == 0
    assert res["invariant_max_err"] == 0.0
    assert np.isfinite(res["final_eval"])
    assert rel_eval <= 1e-3
    # the CPU path runs the kernels' plain versions: nothing is launched
    assert all(c == {} for c in res["kernel_launches_by_worker"].values())


def test_digest_is_identical_across_broker_shards(port_run):
    cfg, res, p0, tmp = port_run
    cfg2 = _port_cfg(tmp / "job2", p0, n_brokers=2, wire_scheme="bitmap",
                     invocation_steps=1_000_000)
    cfg1 = _port_cfg(tmp / "job1", p0, wire_scheme="bitmap",
                     invocation_steps=1_000_000)
    r2, r1 = run_job(cfg2), run_job(cfg1)
    assert r2["dup_mismatches"] == r1["dup_mismatches"] == 0
    assert r2["wire_bytes_total"] == r1["wire_bytes_total"]
    assert supervisor.final_params_digest(cfg2) == \
        supervisor.final_params_digest(cfg1)


def test_killed_worker_respawns_and_replays_bit_identically(port_run):
    """SIGKILL mid-job: the respawned worker restores its newest checkpoint
    and replays; publishes dup-check identical and the params match the
    same job run without the kill."""
    _, _, p0, tmp = port_run
    kw = dict(total_steps=30, invocation_steps=1_000_000, checkpoint_every=1,
              poll_interval_s=0.01)
    base = _port_cfg(tmp / "nokill", p0, **kw)
    kcfg = _port_cfg(tmp / "killed", p0, kill_worker_at_step=(1, 1), **kw)
    bres, kres = run_job(base), run_job(kcfg)
    assert kres["n_respawns"] == 1 and kres["respawns"][0]["worker"] == 1
    assert kres["dup_mismatches"] == 0
    assert kres["wire_bytes_total"] == bres["wire_bytes_total"]
    assert supervisor.final_params_digest(kcfg) == \
        supervisor.final_params_digest(base)


def test_scripted_eviction_flushes_into_the_survivor(port_run):
    """A scripted scale-in: the leaving worker publishes replica + residual,
    the survivor reintegrates it (mean-preserving) and finishes alone."""
    cfg, _, p0, tmp = port_run
    ecfg = _port_cfg(tmp / "evict", p0, total_steps=30,
                     invocation_steps=1_000_000, poll_interval_s=0.01,
                     scripted_evict_steps=(1,))
    res = run_job(ecfg)
    assert res["final_pool"] == 1 and len(res["scale_events"]) == 1
    ev = res["scale_events"][0]
    assert ev["worker"] == 1 and 1 < ev["evict_step"] <= 30
    assert res["history"][-1]["p_active"] == 1
    assert res["dup_mismatches"] == 0 and np.isfinite(res["final_eval"])


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "missing = {'repro_torch.models.lr', 'repro_torch.kernels.fused_adam',\n"
        "           'repro_torch.kernels.ops', 'repro_torch.launch.serve',\n"
        "           'repro_torch.kernels.flash_attention',\n"
        "           'repro_torch.kernels.slstm_scan',\n"
        "           'repro_torch.models.transformer',\n"
        "           'repro_torch.models.xlstm', 'repro_torch.models.attention',\n"
        "           'repro_torch.configs', 'repro_torch.data.tokens',\n"
        "           'repro_torch.dist.compression', 'repro_torch.dist.elastic',\n"
        "           'repro_torch.launch.train'}\n"
        "missing -= set(names)\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 54 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_does_not_import_jax():
    with open(os.path.join(SRC, "..", "chip_smoke.py")) as f:
        text = f.read()
    assert "import jax" not in text and "from repro." not in text
    assert "from repro_torch" in text


def test_entry_points_refuse_a_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--runtime",
         "faas", "--steps", "1", "--workers", "1",
         "--run-dir", str(tmp_path / "r")],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    with pytest.raises(RuntimeError):
        supervisor.Supervisor(FaaSJobConfig(run_dir=str(tmp_path / "s")))


@pytest.mark.parametrize("kw", (
    {"argv": ["--jobs", "a,b"]},
    {"argv": ["--retune", "4:n_brokers=2"]},
    {"argv": ["--topology-tune"]},
))
def test_unported_options_raise(tmp_path, monkeypatch, kw):
    """What the port still refuses: the fleet, retune and topology-tune
    flags of the CLI (SSP and shm are ported: tests/test_torch_ssp.py,
    test_torch_shm.py; chaos, prewarm and hostperf: test_torch_chaos.py,
    test_torch_prewarm.py)."""
    from repro_torch.launch import train as train_cli

    monkeypatch.setattr(sys, "argv", [
        "train", "--runtime", "faas", "--device", "cpu", "--steps", "1",
        "--run-dir", str(tmp_path / "r"), *kw["argv"]])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_cli.main()
    assert not os.path.exists(tmp_path / "r")  # refused before any spawn


def test_result_reports_what_the_driver_reads(port_run):
    _, res, _, _ = port_run
    json.dumps(res)  # JSON-serialisable end to end
    for k in ("fetch", "compute", "encode", "wire", "decode"):
        assert res["phase_s_mean"][k] >= 0.0
    assert res["device"] == "cpu" and res["wire_impl"] == "cuda"
