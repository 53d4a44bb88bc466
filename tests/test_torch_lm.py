"""The port's LM-zoo serving slice held to the JAX package on the CPU.

The smoke configs of every ported arch (phi4-mini: GQA attention, SwiGLU;
gemma3: 1:1 sliding-window and global attention, GeGLU, head_dim 16;
qwen1.5: QKV bias; starcoder2: LayerNorm, GELU MLP; mixtral: sliding
window and MoE, 4 experts split into 16 virtual ones; phi3.5-moe: global
attention and MoE; xlstm: mLSTM + sLSTM) run with the JAX package's
parameters carried across as numpy leaves (``convert.from_leaves``):
``LM.prefill`` logits and cache, then four greedy ``decode_step``s of
logits and cache, against JAX ``LM``, with equal greedy tokens and, for
MoE, the same experts chosen for every token of every layer at every step
(checked before the logits). A 40-token prompt against the smoke window
of 16 (gemma3, mixtral) crosses the window in prefill (JAX takes its
banded core there), fills the rings from the tail and wraps them in
decode. In float32 (both dtypes replaced) within 1e-4 (the largest
differences measured: 1e-6 on logits, 1.2e-5 on the xLSTM caches). In the
configs' own bfloat16 within 0.05, relative and absolute: the two
frameworks round bf16 products at other places; measured, 0.016 on
logits of magnitude up to 3.2, and up to 0.21 absolute on the larger
entries of the mLSTM matrix memory. ``serve()`` on the CPU against the
JAX ``serve()``, the token pipeline bit for bit, and the full configs'
parameter and active-parameter counts complete the slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_arch as jget_arch, get_smoke as jget_smoke
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.launch import serve as jserve
from repro.models import params as jpdefs
from repro.models import transformer as jtransformer
from repro.models.transformer import LM as JLM

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_NAMES, get_arch, get_smoke
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import params as pdefs
from repro_torch.models import transformer
from repro_torch.models.transformer import LM

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("phi4-mini-3.8b", "gemma3-12b", "qwen1.5-32b", "starcoder2-7b",
         "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b")
WINDOWED = ("gemma3-12b", "mixtral-8x22b")  # smoke window 16
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, PROMPT, STEPS = 2, 16, 4
LONG_PROMPT = 40  # past the smoke window of 16: the rings wrap


def _cfgs(arch: str, dtype: str):
    kw = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(jget_smoke(arch), **kw),
            dataclasses.replace(get_smoke(arch), **kw))


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _close(got: list, want: list, tol: float, what: str) -> float:
    assert len(got) == len(want), what
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)
        worst = max(worst, float(np.max(np.abs(g - w), initial=0.0)))
    return worst


@pytest.fixture
def expert_choices(monkeypatch):
    """Record the experts both packages' MoE layers choose, call by call:
    ``{"jax": [...], "port": [...]}`` of (tokens, k) int arrays."""
    seen = {"jax": [], "port": []}
    jmoe_apply, pmoe_apply = jtransformer.moe_apply, transformer.moe_apply

    def jax_side(cfg, p, x, policy=None):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.moe.top_k)
        jax.debug.callback(lambda i: seen["jax"].append(np.asarray(i)), ids)
        return jmoe_apply(cfg, p, x, policy=policy)

    def port_side(cfg, p, x):
        _, _, ids = moe.route(cfg, p, x.reshape(-1, x.shape[-1]))
        seen["port"].append(ids.numpy())
        return pmoe_apply(cfg, p, x)

    monkeypatch.setattr(jtransformer, "moe_apply", jax_side)
    monkeypatch.setattr(transformer, "moe_apply", port_side)
    return seen


def _same_experts(seen: dict, what: str) -> None:
    """Every MoE call chose the same experts in both packages; a flip is
    reported with its call and assignments, never tolerated."""
    assert len(seen["port"]) == len(seen["jax"]), what
    flips = [(i, int(np.sum(a != b)))
             for i, (a, b) in enumerate(zip(seen["port"], seen["jax"]))
             if a.shape != b.shape or np.any(a != b)]
    assert not flips, f"{what}: expert choice differs (call, flips) {flips}"
    seen["port"].clear()
    seen["jax"].clear()


def _prefill_and_decode(arch: str, dtype: str, prompt: int,
                        seen: dict) -> None:
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = convert.from_leaves(pdefs.empty(lm.param_defs()),
                                 [np.asarray(x) for x in
                                  jax.tree_util.tree_leaves(jparams)])
    max_len = prompt + STEPS
    tokens = JTokenPipeline(cfg.vocab_size, prompt, B, seed=1).next_batch(0)[
        "tokens"]
    jlogits, jcache = jax.jit(jlm.prefill)(
        jparams, jlm.init_cache(B, max_len), {"tokens": jnp.asarray(tokens)})
    logits, cache = lm.prefill(params, lm.init_cache(B, max_len),
                               {"tokens": torch.tensor(np.asarray(tokens))})
    tol = TOL[dtype]
    _same_experts(seen, "prefill")
    _close([logits.numpy()], _leaves(jlogits), tol, "prefill logits")
    _close(convert.to_leaves(cache), _leaves(jcache), tol, "prefill cache")
    decode = jax.jit(jlm.decode_step)
    for step in range(STEPS):
        jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        assert tok.tolist() == np.asarray(jtok).tolist(), f"step {step}"
        pos = prompt + step
        jlogits, jcache = decode(jparams, jcache, {"tokens": jtok[:, None]},
                                 jnp.int32(pos))
        logits, cache = lm.decode_step(params, cache,
                                       {"tokens": tok[:, None]}, pos)
        _same_experts(seen, f"decode {step}")
        _close([logits.numpy()], _leaves(jlogits), tol, f"decode {step}")
        _close(convert.to_leaves(cache), _leaves(jcache), tol,
               f"decode {step} cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, expert_choices):
    _prefill_and_decode(arch, dtype, PROMPT, expert_choices)


@pytest.mark.parametrize("arch", WINDOWED)
def test_prompt_past_the_window_wraps_the_ring(arch, expert_choices):
    """40 tokens against a window of 16, in float32: prefill masks keys
    past the window and keeps the last 16 positions at slot ``p % 16``
    (the ring's caches are (B, 16, K*Dh) in both packages); 4 decode
    steps write slots 8..11 and attend over the rebuilt positions. (In
    bfloat16, mixtral-smoke's second layer routes one of the 160
    assignments of this prompt to another expert in each package: the
    frameworks round bf16 at other places, and that token's second and
    third routing probabilities, 0.2787 and 0.2786, differ by 1.6e-4.)"""
    cfg = get_smoke(arch)
    local = [s for sb, _ in cfg.groups for s in sb if s.window]
    assert local and all(LONG_PROMPT > s.window for s in local)
    rings = [d.shape for d in tree_lib.leaves(
        LM(cfg).cache_defs(B, LONG_PROMPT + STEPS)) if d.shape[2] == 16]
    assert rings  # (reps, B, 16, K*Dh)
    _prefill_and_decode(arch, "float32", LONG_PROMPT, expert_choices)


def _serve_args(arch: str, **kw) -> argparse.Namespace:
    a = dict(arch=arch, smoke=True, requests=3, slots=2, prompt_len=16,
             gen_len=4, seed=0, out=None)
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_serve(arch):
    want = jserve.serve(_serve_args(arch))
    got = serve.serve(_serve_args(arch, device="cpu"))
    for key in ("arch", "requests", "slots", "decode_steps", "new_tokens"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu" and got["kernel_launches"] == {}
    # the reference's quirk, kept: only the first `slots` requests finish
    assert got["new_tokens"] == 2 * 4


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_token_pipeline_is_bit_identical(seed, step):
    want = JTokenPipeline(300, 24, 5, seed=seed).next_batch(step)
    got = TokenPipeline(300, 24, 5, seed=seed).next_batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_and_parameter_counts_match(arch):
    """The full configs, field for field, and their parameter counts and
    bytes, from the declarations alone (nothing is allocated)."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert repr(cfg) == repr(jcfg)
    assert repr(get_smoke(arch)) == repr(jget_smoke(arch))
    lm, jlm = LM(cfg), JLM(jcfg)
    assert lm.n_params() == jlm.n_params()
    assert lm.n_active_params() == jlm.n_active_params()
    assert pdefs.param_bytes(lm.param_defs()) == jpdefs.param_bytes(
        jlm.param_defs())


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in ARCHS])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError):
        get_arch(arch)


@pytest.mark.parametrize("arch,what", [
    ("gemma3-12b", "local_attn"), ("mixtral-8x22b", "local_attn"),
    ("phi3.5-moe-42b-a6.6b", "MoE FF")])
def test_training_refuses_local_attention_and_moe(arch, what):
    """Serving only: training through sliding-window attention and the MoE
    FF (whose aux loss the JAX package adds at 0.01) is refused, so an MoE
    model of global attention cannot train silently without its aux."""
    lm = LM(get_smoke(arch))
    with pytest.raises(NotImplementedError, match=what):
        lm.train_loss({}, {"tokens": torch.zeros((1, 8), dtype=torch.int32),
                           "labels": torch.zeros((1, 8), dtype=torch.int32)})


def test_serve_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve(_serve_args("xlstm-1.3b", device="cuda"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "2",
         "--prompt-len", "8", "--gen-len", "2"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
