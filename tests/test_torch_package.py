"""The port's package surface, held to the JAX package's.

* Every public name of each JAX package ``__init__`` exists in the port's,
  but for the names ROADMAP.md §A lists as not yet ported (each is checked
  to be listed there).
* The package ``__init__``s import on first use: the broker's module still
  imports no torch.
* ``data.synthetic_token_batch`` equals JAX's bit for bit.
* ``pmf_quickstart_config`` has JAX's fields and values, but for the
  port's device rule (``device`` and ``wire_impl`` are ``cuda``).
* ``retain_updates``: the result's merged ``updates`` of a small PMF job
  match JAX's run of the same job from the same initial parameters:
  the same (worker, step) keys; the sent elements agree but for at most 1%
  of them (a flip at the ISP threshold, where the frameworks' gradient
  sums differ in order); where both sent, within 1e-3 relative (the
  runtime test's tolerance, tests/test_torch_runtime.py).
* ``launch.train.register_runtime`` adds a runtime the CLI dispatches to.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.data import tokens as jtokens
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import build_workload as jbuild_workload
from repro.runtime import pmf_quickstart_config as jquickstart
from repro.runtime import run_job as jrun_job

from repro_torch import convert
from repro_torch.data import tokens

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PACKAGES = ("checkpoint", "core", "data", "dist", "kernels", "launch",
            "models", "optim", "runtime", "wire")
# names of a JAX package __init__ whose module is not ported yet; each
# must stand in ROADMAP.md §A
NOT_PORTED = {"checkpoint": ("restore_with_sharding",)}


def _jax_exports(package: str) -> list[str]:
    """The names ``src/repro/<package>/__init__.py`` binds: what its
    imports bring in and its ``__all__``."""
    path = os.path.join(SRC, "repro", package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names.update(ast.literal_eval(node.value))
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_the_jax_names(package):
    port = importlib.import_module(f"repro_torch.{package}")
    skip = set(NOT_PORTED.get(package, ()))
    missing = [n for n in _jax_exports(package)
               if n not in skip and not hasattr(port, n)]
    assert missing == []
    for name in skip:
        assert not hasattr(port, name)  # ported: drop it from NOT_PORTED


def test_names_left_out_stand_in_the_roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    queue = text[text.index("### A."):text.index("### B.")]
    for names in NOT_PORTED.values():
        for name in names:
            assert name in queue, name


def test_package_imports_stay_light():
    """The broker imports no torch (its shard processes start fast); the
    runtime package resolves its names on first use."""
    code = ("import sys\n"
            "import repro_torch.runtime.broker\n"
            "import repro_torch.wire, repro_torch.core, repro_torch.data\n"
            "light = 'torch' not in sys.modules\n"
            "from repro_torch.runtime import FleetConfig, run_job\n"
            "print(light, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True"]


@pytest.mark.parametrize("vocab,seq,batch,seed", (
    (8192, 32, 4, 0), (50, 7, 3, 5), (32768, 16, 2, 11)))
def test_synthetic_token_batch_matches_jax(vocab, seq, batch, seed):
    got = tokens.synthetic_token_batch(vocab, seq, batch, seed)
    want = jtokens.synthetic_token_batch(vocab, seq, batch, seed)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert got[k].tobytes() == w.tobytes()


def test_pmf_quickstart_config_has_jax_fields(tmp_path):
    from repro_torch.runtime import (PMF_QUICKSTART_CFG,
                                     pmf_quickstart_config)
    from repro.runtime import PMF_QUICKSTART_CFG as JCFG

    assert PMF_QUICKSTART_CFG == JCFG
    for consistency in ("isp", "ssp"):
        got = pmf_quickstart_config(str(tmp_path), consistency=consistency)
        want = jquickstart(str(tmp_path), consistency=consistency)
        port_fields = {f.name for f in dataclasses.fields(got)}
        for f in dataclasses.fields(want):
            if f.name in ("wire_impl", "force_cpu"):
                continue  # the JAX package's CPU and codec defaults
            assert f.name in port_fields, f.name
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(w):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, f.name
        assert got.device == "cuda" and got.wire_impl == "cuda"
    assert pmf_quickstart_config(str(tmp_path), device="cpu").device == "cpu"


def test_retained_updates_match_jax(tmp_path):
    from repro_torch.runtime import FaaSJobConfig, run_job

    wcfg = {"n_users": 120, "n_movies": 150, "n_ratings": 6000, "rank": 4,
            "batch_size": 64}
    job = dict(workload="pmf", n_workers=2, total_steps=6,
               invocation_steps=3, checkpoint_every=100,
               optimizer="nesterov", lr=0.08, isp_v=0.5, deadline_s=180.0,
               retain_updates=True)
    jp = jbuild_workload("pmf", wcfg).params0
    p0 = convert.write_params0(str(tmp_path / "params0.npz"), ["U", "M"],
                               [np.asarray(jp.U), np.asarray(jp.M)])
    res = run_job(FaaSJobConfig(run_dir=str(tmp_path / "port"),
                                device="cpu",
                                workload_cfg=dict(wcfg, params0=p0), **job))
    jres = jrun_job(JFaaSJobConfig(run_dir=str(tmp_path / "jax"),
                                   workload_cfg=dict(wcfg), **job))
    got, want = res["updates"], jres["updates"]
    assert [(u["worker"], u["step"]) for u in got] == [
        (u["worker"], u["step"]) for u in want]
    assert len(got) == 2 * 6
    flips = sent = 0
    worst = 0.0
    for a, b in zip(got, want):
        for k in ("U", "M"):
            x = getattr(a["update"], k).numpy()
            y = np.asarray(getattr(b["update"], k))
            both = (x != 0) & (y != 0)
            flips += int(((x != 0) != (y != 0)).sum())
            sent += int((y != 0).sum())
            if both.any():
                worst = max(worst, float(np.max(
                    np.abs(x[both] - y[both]) / np.abs(y[both]))))
    print(f"retained updates: {sent} sent elements, {flips} flips, worst "
          f"relative difference {worst:.3e}")
    assert sent > 0
    assert flips <= 0.01 * sent
    assert worst <= 1e-3


def test_register_runtime_adds_a_runtime(monkeypatch, capsys):
    from repro_torch.launch import train as train_cli

    assert {"inproc", "faas"} <= set(train_cli.RUNTIMES)
    monkeypatch.setattr(train_cli, "RUNTIMES", dict(train_cli.RUNTIMES))

    @train_cli.register_runtime("echo")
    def echo(args) -> dict:
        return {"runtime": args.runtime, "steps": args.steps,
                "history": [1, 2]}

    assert train_cli.RUNTIMES["echo"] is echo
    monkeypatch.setattr(sys, "argv", ["train", "--runtime", "echo",
                                      "--steps", "3"])
    train_cli.main()
    out = json.loads(capsys.readouterr().out)
    assert out == {"runtime": "echo", "steps": 3}  # the history left out
