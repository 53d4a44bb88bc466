"""The port's in-process trainer (``bsp``, ``isp`` and ``isp-pod``) held to
the JAX package on the CPU.

The loss and its gradients through ``LM.train_loss`` (attention through
``kernels.flash_attention.FlashAttention``, whose backward recomputes the
plain version) against ``jax.value_and_grad`` of the JAX model: a tiny
arch in float32 within 1e-4 and lm-8m's shape in its own bfloat16 within
the 0.05 of ``tests/test_torch_lm.py``. Then ``train()`` for four steps of
``isp-pod`` at three pods against the JAX ``train()`` on the same
parameters (carried across as numpy leaves): in float32 per-step losses
within 1e-4 relative and sent fractions within 1e-3; in bfloat16, with the
JAX exchange switched to its fused kernels (what the card computes),
within the tolerances stated at that test. The same for ``bsp`` and
``isp`` under Adam (B3 and B2 on every leaf), SGD and Nesterov, and an
``isp`` run scaled in by the auto-tuner. Checkpoints of the lifted pod
state and of the flat state cross both ways, and ``--restore`` resumes at
the checkpointed pool.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.dist import compression as jcomp
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models.transformer import LM as JLM

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import build, flash_attention, ref
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models import params as pdefs
from repro_torch.models.config import BlockSpec, FF, Mixer, uniform_groups
from repro_torch.models.transformer import LM

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tiny(mod, dtype: str = "float32"):
    """d 64, 2 layers, 2 heads (Dh 32), SwiGLU 128, vocab 512."""
    return dataclasses.replace(
        mod.LM_8M, name="lm-tiny", d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        groups=mod.uniform_groups(
            mod.BlockSpec(mod.Mixer.GLOBAL_ATTN, mod.FF.SWIGLU), 2),
        param_dtype=dtype, activation_dtype=dtype)


def _pair(dtype: str = "float32", lm8m: bool = False):
    """(JAX cfg, port cfg) of the tiny arch, or of lm-8m in ``dtype``."""
    if lm8m:
        kw = dict(param_dtype=dtype, activation_dtype=dtype)
        return (dataclasses.replace(jtrain.LM_8M, **kw),
                dataclasses.replace(train.LM_8M, **kw))
    return _tiny(jtrain, dtype), _tiny(train, dtype)


def _jparams(jcfg, seed: int = 0):
    return JLM(jcfg).init(jax.random.PRNGKey(seed))


def _port_params(cfg, jparams, requires_grad: bool = False):
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    params = convert.from_leaves(pdefs.empty(LM(cfg).param_defs()), leaves)
    if requires_grad:
        for x in tree_lib.leaves(params):
            x.requires_grad_(True)
    return params


def _batch(vocab: int, b: int, s: int, seed: int = 1):
    return TokenPipeline(vocab, s, b, seed=seed).next_batch(0)


# -- the loss and its gradients ----------------------------------------------------


def test_chunked_softmax_xent_matches_jax():
    """Two full chunks and a remainder, a loss mask, padded vocab columns."""
    jcfg, cfg = _pair()
    jcfg = dataclasses.replace(jcfg, vocab_size=500)  # padded to 512
    cfg = dataclasses.replace(cfg, vocab_size=500)
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, 21, 64)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 21)).astype(np.int32)
    mask = (rng.random((2, 21)) < 0.8).astype(np.float32)
    tok = (rng.standard_normal((512, 64)) * 0.1).astype(np.float32)
    got = layers.chunked_softmax_xent(
        cfg, {"tok": torch.from_numpy(tok)}, torch.from_numpy(hidden),
        torch.from_numpy(labels), torch.from_numpy(mask), chunk=8)
    want = jlayers.chunked_softmax_xent(
        jcfg, {"tok": jnp.asarray(tok)}, jnp.asarray(hidden),
        jnp.asarray(labels), jnp.asarray(mask), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype,lm8m,tol", (("float32", False, 1e-4),
                                            ("bfloat16", True, 5e-2)))
def test_train_loss_and_grads_match_jax(dtype, lm8m, tol):
    """Every leaf's gradient against ``jax.value_and_grad``; every one is
    nonzero, so no leaf is cut from the graph (the attention projections
    get theirs through FlashAttention's backward)."""
    jcfg, cfg = _pair(dtype, lm8m)
    jparams = _jparams(jcfg)
    params = _port_params(cfg, jparams, requires_grad=True)
    batch = _batch(cfg.vocab_size, 2, 24)
    (jloss, _), jgrads = jax.value_and_grad(JLM(jcfg).train_loss,
                                            has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = LM(cfg).train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(metrics["moe_aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol)
    leaves = tree_lib.leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    keys = tree_lib.tree_keys(params)
    for key, g, jg in zip(keys, grads, jax.tree_util.tree_leaves(jgrads)):
        g = g.float().numpy()
        jg = np.asarray(jg, np.float32)
        assert np.abs(g).max() > 0, key
        scale = np.abs(jg).max()
        np.testing.assert_allclose(g, jg, rtol=tol, atol=tol * scale,
                                   err_msg=key)


def test_flash_attention_backward_is_the_plain_gradient():
    """FlashAttention's gradients equal autograd through ``ref.mha_ref``
    (the backward recomputes it), GQA and a window included, and an input
    that needs no gradient gets none."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 32, generator=gen, requires_grad=True)
    k = torch.randn(2, 40, 2, 32, generator=gen, requires_grad=True)
    v = torch.randn(2, 40, 2, 32, generator=gen)
    go = torch.randn(2, 40, 4, 32, generator=gen)
    for kw in (dict(causal=True), dict(causal=True, window=7),
               dict(causal=False)):
        out = flash_attention.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k), go)
        want = torch.autograd.grad(ref.mha_ref(q, k, v, **kw), (q, k), go)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert 32 in flash_attention.HEAD_DIMS


@pytest.mark.cuda
def test_flash_attention_gradients_on_the_card():
    """One lm-100m attention shape (B 4, S 256, H 12, Dh 64) and lm-8m's
    Dh 32 in bf16: the kernel's forward and the gradients of every input
    through FlashAttention against autograd through ``ref.mha_ref`` on the
    card, within bf16's 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for h, dh in ((12, 64), (8, 32)):
        q, k, v, go = (torch.randn(4, 256, h, dh, generator=gen, device=dev)
                       .to(torch.bfloat16).requires_grad_(i < 3)
                       for i in range(4))
        build.reset_launches()
        out = flash_attention.flash_attention(q, k, v)
        assert build.LAUNCHES["flash_attention"] == 1
        got = torch.autograd.grad(out, (q, k, v), go)
        want_out = ref.mha_ref(q, k, v)
        want = torch.autograd.grad(want_out, (q, k, v), go)
        for g, w in zip((out,) + got, (want_out,) + want):
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)


# -- train() against the JAX train() ---------------------------------------------


def _args(**kw) -> argparse.Namespace:
    a = dict(arch="lm-tiny", smoke=False, steps=4, workers=3,
             per_worker_batch=2, seq=16, mode="isp-pod", isp_v=0.7,
             scheme="bitmap", budget=0.05, wire_scheme=None,
             optimizer="adam", lr=3e-4, autotune=False, sched_interval=20.0,
             checkpoint_dir=None, checkpoint_every=50, restore=False,
             log_every=100, seed=0, out=None, device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.fixture
def tiny(monkeypatch):
    """Register lm-tiny in both drivers and start the port from the JAX
    parameters (the two packages draw different random initial values)."""
    def register(dtype: str):
        jcfg, cfg = _pair(dtype)
        monkeypatch.setitem(jtrain._EXTRA, "lm-tiny", jcfg)
        monkeypatch.setitem(train._EXTRA, "lm-tiny", cfg)
        jparams = _jparams(jcfg)

        def init(self, seed, device="cpu"):
            return tree_lib.tree_map(
                lambda x: x.to(device), _port_params(self.cfg, jparams))

        monkeypatch.setattr(train.LM, "init", init)
    return register


def _run_both(args):
    jres = jtrain.train(args)
    res = train.train(args)
    return res, jres


@pytest.mark.parametrize("scheme", ("dense", "topk", "bitmap"))
def test_train_isp_pod_float32_matches_jax(tiny, scheme):
    """At the CLI's defaults (Adam, lr 3e-4, v 0.7); measured, the losses
    agree within 1.5e-6. The filter and the top-k are discontinuous: at a
    larger lr a float32 difference in summation order can flip an entry
    at the threshold, after which the two runs part."""
    tiny("float32")
    res, jres = _run_both(_args(scheme=scheme))
    assert res["steps"] == jres["steps"] == 4
    assert res["final_pool"] == jres["final_pool"] == 3
    for h, jh in zip(res["history"], jres["history"]):
        assert h["step"] == jh["step"] and h["pool"] == jh["pool"]
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-4)
        assert abs(h["sent_fraction"] - jh["sent_fraction"]) <= 1e-3
    assert 0.0 < res["mean_sent_fraction"] < 1.0
    assert res["device"] == "cpu" and res["kernel_launches"] == {}
    for key in jres:
        assert key in res, key


@pytest.mark.parametrize("scheme", ("dense", "topk", "bitmap"))
def test_train_isp_pod_bf16_matches_fused_jax(tiny, monkeypatch, scheme):
    """bf16 in both, on the JAX ``fused=True`` exchange (Pallas
    interpret), at the CLI's defaults: losses within 5e-4 relative and
    sent fractions within 2e-4 (measured 6.1e-5 and 3.2e-5: the two
    frameworks' bf16 forwards round at other places, 4.6e-5 on the first
    loss, and the filter's threshold cuts through rounded values)."""
    tiny("bfloat16")
    monkeypatch.setattr(jtrain, "CompressionConfig", functools.partial(
        jcomp.CompressionConfig, fused=True, interpret=True))
    res, jres = _run_both(_args(scheme=scheme))
    for h, jh in zip(res["history"], jres["history"]):
        assert h["loss"] == pytest.approx(jh["loss"], rel=5e-4)
        assert abs(h["sent_fraction"] - jh["sent_fraction"]) <= 2e-4
    assert 0.0 < res["mean_sent_fraction"] < 1.0


# a learning rate per optimizer at which the tiny arch's filter sends
# something in four steps
FLAT_LR = {"adam": 3e-4, "sgd": 0.5, "nesterov": 0.1}
# (losses relative, sent fractions absolute) per dtype
FLAT_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-4, 2e-4)}


@pytest.fixture
def jax_distinct_moments(monkeypatch):
    """JAX's ``sgd`` and ``nesterov`` init ``OptState(step, z, z)``, one
    tree for both moments, and JAX's ``make_step`` donates the optimizer
    state, so ``jtrain.train`` in ``bsp``/``isp`` with either raises
    "donate the same buffer twice". Hand the JAX driver a copy of ``nu``;
    the arithmetic is unchanged."""
    make = jtrain.optim.make

    def make_distinct(name, lr, **kw):
        opt = make(name, lr, **kw)

        def init(params):
            st = opt.init(params)
            return st._replace(nu=jax.tree.map(jnp.copy, st.nu))

        return dataclasses.replace(opt, init=init)

    monkeypatch.setattr(jtrain.optim, "make", make_distinct)


def _assert_histories_agree(res, jres, dtype: str) -> None:
    loss_tol, sent_tol = FLAT_TOL[dtype]
    assert len(res["history"]) == len(jres["history"])
    for h, jh in zip(res["history"], jres["history"]):
        assert h["step"] == jh["step"] and h["pool"] == jh["pool"]
        assert h["loss"] == pytest.approx(jh["loss"], rel=loss_tol)
        assert abs(h["sent_fraction"] - jh["sent_fraction"]) <= sent_tol


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("optimizer", ("adam", "sgd", "nesterov"))
@pytest.mark.parametrize("mode", ("bsp", "isp"))
def test_train_flat_modes_match_jax(tiny, jax_distinct_moments, mode,
                                    optimizer, dtype):
    """``bsp`` and ``isp`` for four steps at three workers against the JAX
    ``train()`` on the same parameters: in float32 losses within 1e-4
    relative and sent fractions within 1e-3 (measured: 2.3e-7 and 1.9e-9);
    in bfloat16 within 5e-4 and 2e-4 (measured up to 9.7e-5 and 1.0e-4).
    Under Adam the port runs B3 or B2 (each leaf once, in float32 with one
    rounding per output), where JAX runs ``optim.adam`` and the split in
    jnp, which round bfloat16 after each operation."""
    tiny(dtype)
    res, jres = _run_both(_args(mode=mode, optimizer=optimizer,
                                lr=FLAT_LR[optimizer]))
    assert res["steps"] == jres["steps"] == 4
    _assert_histories_agree(res, jres, dtype)
    if mode == "bsp":
        assert res["mean_sent_fraction"] == 1.0
    else:
        assert 0.0 < res["mean_sent_fraction"] < 1.0
    assert res["device"] == "cpu" and res["kernel_launches"] == {}
    for key in jres:
        assert key in res, key


@pytest.mark.parametrize("mode,dtype", (("isp", "float32"),
                                        ("isp", "bfloat16"),
                                        ("bsp", "float32")))
def test_flat_scale_in_matches_jax(tiny, monkeypatch, tmp_path, mode, dtype):
    """An auto-tuned run that scales in from 3 workers to 2 after step 2,
    in both drivers. Under ``isp`` the flushed parameters equal JAX's
    ``apply_updates(params, residual)`` on the port's state bit for bit and
    the residual is zero after; the losses of all five steps agree within
    the tolerances of ``test_train_flat_modes_match_jax``; the transition
    checkpoints."""
    tiny(dtype)
    from repro import optim as joptim

    seen = {}
    flat = train.MODES[mode]

    def scale_in(args, st, plan, isp):
        seen["before"] = convert.to_leaves({"p": st.params,
                                            "r": st.residual})
        st = flat.scale_in(args, st, plan, isp)
        seen["after"] = convert.to_leaves({"p": st.params,
                                           "r": st.residual})
        return st

    monkeypatch.setitem(train.MODES, mode,
                        dataclasses.replace(flat, scale_in=scale_in))
    out = {}
    for name, mod in (("port", train), ("jax", jtrain)):
        calls = []

        def decide(self):
            calls.append(1)
            return argparse.Namespace(remove_worker=len(calls) == 2)

        monkeypatch.setattr(mod.ScaleInAutoTuner, "decide", decide)
        d = str(tmp_path / name)
        out[name] = mod.train(_args(mode=mode, steps=5, autotune=True,
                                    checkpoint_dir=d, checkpoint_every=50))
        assert os.path.isdir(os.path.join(d, "step_0000000002"))
    res, jres = out["port"], out["jax"]
    assert [h["pool"] for h in res["history"]] == [3, 3, 2, 2, 2]
    assert res["final_pool"] == jres["final_pool"] == 2
    _assert_histories_agree(res, jres, dtype)
    n = len(seen["before"]) // 2
    params, residual = seen["before"][:n], seen["before"][n:]
    flushed, res_after = seen["after"][:n], seen["after"][n:]
    if mode == "isp":
        assert any(np.any(np.asarray(r, np.float32) != 0) for r in residual)
        want = joptim.apply_updates([jnp.asarray(p) for p in params],
                                    [jnp.asarray(r) for r in residual])
    else:
        want = params
    for got, w in zip(flushed, want):
        w = np.asarray(w)
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes()
    for r in res_after:
        assert not np.any(np.asarray(r, np.float32) != 0)


def _state_leaves(st) -> list:
    return convert.to_leaves({"params": st.params, "opt": st.opt_state,
                              "residual": st.residual})


def _jstate_leaves(st) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        {"params": st.params, "opt": st.opt_state, "residual": st.residual})]


def _states(dtype: str, pods: int = 0):
    """The same train state in both packages: lifted over ``pods`` pods,
    or the flat state of ``bsp``/``isp`` when 0; non-zero moments and
    residuals in the parameters' dtype."""
    jcfg, cfg = _pair(dtype)
    jparams = _jparams(jcfg)
    from repro import optim as joptim

    jopt = joptim.adam(1e-3).init(jparams)
    rng = np.random.default_rng(0)
    lead = (pods,) if pods else ()
    noise = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(lead + x.shape) * 1e-3,
                              x.dtype), t)
    jopt = joptim.OptState(jnp.full(lead, 5, jnp.int32), noise(jopt.mu),
                           noise(jopt.nu))
    jst = jtrain.TrainState(jparams, jopt, noise(jparams), step=4, pool=3)
    from repro_torch import optim

    params = _port_params(cfg, jparams)
    opt, res = optim.adam(1e-3).init(params), params
    if pods:
        opt, res = train.lift_pod(opt, pods), train.lift_pod(res, pods)
    like = train.TrainState(params, opt, res, step=0, pool=1)
    return jst, like


def _assert_checkpoints_cross(tmp_path, jst, like) -> None:
    jd, d = str(tmp_path / "from_jax"), str(tmp_path / "from_port")
    jtrain.save_checkpoint(jd, jst)
    st = train.restore_checkpoint(jd, like)
    assert (st.step, st.pool) == (4, 3)
    got, want = _state_leaves(st), _jstate_leaves(jst)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    train.save_checkpoint(d, st)
    back = jtrain.restore_checkpoint(d, jtrain.TrainState(
        jst.params, jst.opt_state, jst.residual, step=0, pool=1))
    assert (back.step, back.pool) == (4, 3)
    for g, w in zip(_jstate_leaves(back), want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_pod_checkpoints_cross_both_ways(tmp_path, dtype):
    _assert_checkpoints_cross(tmp_path, *_states(dtype, pods=3))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_flat_checkpoints_cross_both_ways(tmp_path, dtype):
    """The ``bsp``/``isp`` state: params, a 0-d step and moments in the
    parameters' dtype (bfloat16 moments on a bfloat16 model), residual."""
    jst, like = _states(dtype)
    assert jst.opt_state.step.shape == ()
    _assert_checkpoints_cross(tmp_path, jst, like)


def test_restore_resumes_with_the_checkpointed_pool(tiny, tmp_path):
    """A run scaled in to 2 pods checkpoints; ``--restore`` with
    ``--workers 3`` resumes at 2 pods from that step, in both drivers, on
    the same losses."""
    tiny("float32")
    out = {}
    for name, mod in (("port", train), ("jax", jtrain)):
        d = str(tmp_path / name)
        calls = []

        def decide_once(self):
            calls.append(1)
            return argparse.Namespace(remove_worker=len(calls) == 2)

        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setattr(mod.ScaleInAutoTuner, "decide", decide_once)
        try:
            first = mod.train(_args(steps=3, autotune=True, checkpoint_dir=d,
                                    checkpoint_every=3))
        finally:
            monkeypatch.undo()
        second = mod.train(_args(steps=5, restore=True, checkpoint_dir=d))
        out[name] = (first, second)
    for name in out:
        first, second = out[name]
        assert first["final_pool"] == 2
        assert [h["pool"] for h in second["history"]] == [2, 2]
        assert second["steps"] == 5 and second["final_pool"] == 2
    for h, jh in zip(out["port"][1]["history"], out["jax"][1]["history"]):
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-4)


def test_every_mode_is_ported_and_a_missing_card_raises():
    """Every mode of the JAX driver has a step and a scale-in here; the
    default ``--device cuda`` without a card raises, also through the CLI
    with no ``--mode`` (``bsp``)."""
    assert set(train.MODES) == set(jtrain.MODES)
    for name, mode in train.MODES.items():
        assert mode.build_step is not None and mode.scale_in is not None
        assert mode.pod == jtrain.MODES[name].pod
    with pytest.raises(NotImplementedError):
        LM(dataclasses.replace(
            train.LM_8M, groups=uniform_groups(BlockSpec(
                Mixer.SLSTM, FF.NONE), 1), family="ssm")).train_loss({}, {})
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(_args(device="cuda"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "1",
         "--workers", "1", "--seq", "8"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr


def test_cli_runs_isp_pod_on_the_cpu(tmp_path):
    """The CLI's inproc runtime (the default) end to end at lm-8m's width
    (Dh 32), checkpoint and all."""
    path = str(tmp_path / "res.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "lm-8m",
         "--mode", "isp-pod", "--steps", "2", "--workers", "2",
         "--per-worker-batch", "1", "--seq", "16", "--scheme", "topk",
         "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
         "--checkpoint-every", "2", "--out", path],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    with open(path) as f:
        res = json.load(f)
    assert res["steps"] == 2 and res["final_pool"] == 2
    assert np.isfinite(res["final_loss"]) and res["device"] == "cpu"
    assert os.path.isdir(tmp_path / "ck" / "step_0000000002")


def test_cli_default_mode_runs_bsp_on_the_cpu(tmp_path):
    """No ``--mode``: the JAX CLI's default, ``bsp`` with Adam, at lm-8m's
    width on the CPU for two steps (plain versions: no launches)."""
    path = str(tmp_path / "res.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "lm-8m",
         "--steps", "2", "--workers", "2", "--per-worker-batch", "1",
         "--seq", "16", "--device", "cpu", "--out", path],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    with open(path) as f:
        res = json.load(f)
    assert "mode=bsp" in out.stdout
    assert res["steps"] == 2 and res["mean_sent_fraction"] == 1.0
    assert np.isfinite(res["final_loss"]) and res["kernel_launches"] == {}
