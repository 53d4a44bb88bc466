"""The port's LM-zoo serving slice held to the JAX package on the CPU.

phi4-mini-smoke (GQA attention, SwiGLU) and xlstm-smoke (mLSTM + sLSTM)
run with the JAX package's parameters carried across as numpy leaves
(``convert.from_leaves``): ``LM.prefill`` logits and cache, then four
greedy ``decode_step``s of logits and cache, against JAX ``LM``, with
equal greedy tokens. In float32 (both dtypes replaced) within 1e-4 (the
largest differences measured: 1e-6 on logits, 1.2e-5 on the xLSTM
caches). In the configs' own bfloat16 within 0.05, relative and absolute:
the two frameworks round bf16 products at other places; measured, 0.016
on logits of magnitude up to 3.2, and up to 0.21 absolute on the larger
entries of the mLSTM matrix memory. ``serve()`` on the CPU against the JAX
``serve()``, the token pipeline bit for bit, and the full configs' parameter
counts complete the slice.
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
from repro.models.transformer import LM as JLM

from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_arch, get_smoke
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve
from repro_torch.models import params as pdefs
from repro_torch.models.transformer import LM

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("phi4-mini-3.8b", "xlstm-1.3b")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, PROMPT, STEPS = 2, 16, 4


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = convert.from_leaves(pdefs.empty(lm.param_defs()),
                                 [np.asarray(x) for x in
                                  jax.tree_util.tree_leaves(jparams)])
    max_len = PROMPT + STEPS
    tokens = JTokenPipeline(cfg.vocab_size, PROMPT, B, seed=1).next_batch(0)[
        "tokens"]
    jlogits, jcache = jax.jit(jlm.prefill)(
        jparams, jlm.init_cache(B, max_len), {"tokens": jnp.asarray(tokens)})
    logits, cache = lm.prefill(params, lm.init_cache(B, max_len),
                               {"tokens": torch.tensor(np.asarray(tokens))})
    tol = TOL[dtype]
    _close([logits.numpy()], _leaves(jlogits), tol, "prefill logits")
    _close(convert.to_leaves(cache), _leaves(jcache), tol, "prefill cache")
    decode = jax.jit(jlm.decode_step)
    for step in range(STEPS):
        jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        assert tok.tolist() == np.asarray(jtok).tolist(), f"step {step}"
        pos = PROMPT + step
        jlogits, jcache = decode(jparams, jcache, {"tokens": jtok[:, None]},
                                 jnp.int32(pos))
        logits, cache = lm.decode_step(params, cache,
                                       {"tokens": tok[:, None]}, pos)
        _close([logits.numpy()], _leaves(jlogits), tol, f"decode {step}")
        _close(convert.to_leaves(cache), _leaves(jcache), tol,
               f"decode {step} cache")


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
    lm, jlm = LM(cfg), JLM(jcfg)
    assert lm.n_params() == jlm.n_params()
    assert pdefs.param_bytes(lm.param_defs()) == jpdefs.param_bytes(
        jlm.param_defs())


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in ARCHS])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError):
        get_arch(arch)


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
