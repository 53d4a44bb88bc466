"""Shared pytest config: markers, import path, optional-dep degradation.

Two jobs:

1. Register the ``slow`` / ``tpu`` markers and skip them appropriately
   (tpu-marked tests only run on a TPU backend; slow tests need
   ``--run-slow``).
2. Degrade gracefully when optional deps are absent. ``hypothesis`` is the
   big one: three test modules import it at module scope, so a missing
   wheel used to abort the ENTIRE run at collection. When the real package
   is unavailable we install a small deterministic fallback into
   ``sys.modules`` — ``@given`` draws boundary values first, then seeded
   random examples — so the property tests still execute (with less
   adversarial search) instead of exploding.
"""

from __future__ import annotations

import os
import sys
import types
import zlib

import pytest

# `python -m pytest` without PYTHONPATH=src must still collect everything
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


# -- markers ------------------------------------------------------------------


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test; needs --run-slow to execute"
    )
    config.addinivalue_line(
        "markers", "tpu: requires a real TPU backend (skipped on CPU/GPU)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself without one"
    )


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow", action="store_true", default=False,
        help="run tests marked slow",
    )


def pytest_collection_modifyitems(config, items):
    try:
        import jax

        backend = jax.default_backend()
    except Exception:  # jax missing/broken: let the tests report it
        backend = "none"
    skip_tpu = pytest.mark.skip(reason="requires a TPU backend")
    skip_slow = pytest.mark.skip(reason="slow test: pass --run-slow")
    for item in items:
        if "tpu" in item.keywords and backend != "tpu":
            item.add_marker(skip_tpu)
        if "slow" in item.keywords and not config.getoption("--run-slow"):
            item.add_marker(skip_slow)


# -- hypothesis fallback ------------------------------------------------------


class _Unsatisfied(Exception):
    """Raised by the fallback ``assume`` to discard one example."""


class _Strategy:
    """A deterministic value source: boundary values first, then seeded
    random draws. API-compatible with the tiny slice of hypothesis this
    repo's tests use (floats/integers/booleans/sampled_from/lists/just/
    one_of/tuples, plus .map/.filter)."""

    def __init__(self, draw, edges=()):
        self._draw = draw
        self.edges = tuple(edges)

    def example(self, rng, i):
        if i < len(self.edges):
            return self.edges[i]
        return self._draw(rng)

    def map(self, f):
        return _Strategy(
            lambda rng: f(self._draw(rng)), [f(e) for e in self.edges]
        )

    def filter(self, pred):
        def draw(rng):
            for _ in range(1000):
                v = self._draw(rng)
                if pred(v):
                    return v
            raise _Unsatisfied("filter never satisfied")

        return _Strategy(draw, [e for e in self.edges if pred(e)])


def _make_strategies():
    import numpy as np

    st = types.ModuleType("hypothesis.strategies")

    def floats(min_value=0.0, max_value=1.0, **_kw):
        lo, hi = float(min_value), float(max_value)
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)), (lo, hi))

    def integers(min_value=0, max_value=100, **_kw):
        lo, hi = int(min_value), int(max_value)
        return _Strategy(lambda rng: int(rng.randint(lo, hi + 1)), (lo, hi))

    def booleans():
        return _Strategy(lambda rng: bool(rng.randint(0, 2)), (False, True))

    def sampled_from(seq):
        seq = list(seq)
        return _Strategy(
            lambda rng: seq[int(rng.randint(0, len(seq)))], seq[:2]
        )

    def just(value):
        return _Strategy(lambda rng: value, (value,))

    def one_of(*strategies):
        def draw(rng):
            s = strategies[int(rng.randint(0, len(strategies)))]
            return s.example(rng, len(s.edges))  # random draw of that arm

        edges = [s.edges[0] for s in strategies if s.edges][:2]
        return _Strategy(draw, edges)

    def lists(elements, min_size=0, max_size=10, **_kw):
        def draw(rng):
            n = int(rng.randint(min_size, max_size + 1))
            return [elements.example(rng, len(elements.edges) + j)
                    for j in range(n)]

        edges = []
        if min_size == 0:
            edges.append([])
        if elements.edges:
            edges.append([elements.edges[0]] * max(min_size, 1))
        return _Strategy(draw, edges)

    def tuples(*strategies):
        def draw(rng):
            return tuple(
                s.example(rng, len(s.edges)) for s in strategies
            )

        edges = []
        if all(s.edges for s in strategies):
            edges.append(tuple(s.edges[0] for s in strategies))
        return _Strategy(draw, edges)

    st.floats = floats
    st.integers = integers
    st.booleans = booleans
    st.sampled_from = sampled_from
    st.just = just
    st.one_of = one_of
    st.lists = lists
    st.tuples = tuples
    st._rng_type = np.random.RandomState
    return st


def _install_hypothesis_fallback():
    import functools
    import inspect

    import numpy as np

    st = _make_strategies()
    hyp = types.ModuleType("hypothesis")

    def given(*args, **strategies):
        if args:
            raise TypeError(
                "fallback @given supports keyword strategies only"
            )

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                n = getattr(wrapper, "_fallback_max_examples", 10)
                seed = zlib.crc32(fn.__qualname__.encode())
                ran = 0
                for i in range(n):
                    rng = np.random.RandomState((seed + i) % 2**31)
                    drawn = {
                        k: s.example(rng, i) for k, s in strategies.items()
                    }
                    try:
                        fn(*a, **drawn, **kw)
                        ran += 1
                    except _Unsatisfied:
                        continue
                    except Exception as e:
                        raise AssertionError(
                            f"falsifying example (fallback hypothesis) "
                            f"{fn.__name__}({drawn})"
                        ) from e
                if ran == 0:
                    raise _Unsatisfied(
                        f"{fn.__name__}: every example was discarded"
                    )

            wrapper.hypothesis = types.SimpleNamespace(inner_test=fn)
            # pytest must not mistake the drawn params for fixtures
            wrapper.__signature__ = inspect.Signature(
                [p for p in inspect.signature(fn).parameters.values()
                 if p.name not in strategies]
            )
            return wrapper

        return deco

    def settings(max_examples=10, **_kw):
        def deco(fn):
            fn._fallback_max_examples = max_examples
            return fn

        return deco

    def assume(condition):
        if not condition:
            raise _Unsatisfied("assume() failed")
        return True

    class HealthCheck:
        too_slow = data_too_large = filter_too_much = all = None

    hyp.given = given
    hyp.settings = settings
    hyp.assume = assume
    hyp.note = lambda *_a, **_k: None
    hyp.HealthCheck = HealthCheck
    hyp.strategies = st
    hyp.__version__ = "0.0-fallback"
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


try:
    import hypothesis  # noqa: F401  (the real package wins when present)
except ImportError:
    _install_hypothesis_fallback()
