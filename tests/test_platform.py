"""Platform-dependent choices, tested on the CPU by faking the platform:
the kernel gate, tier resolution, the replica budget, the compile-cache
directory, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import rii_tpu
from rii_tpu import PQ, Rii
from rii_tpu import rii as rii_mod

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_engine():
    X = np.random.RandomState(0).random((1000, 16)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16).fit(X[:500], iter=3))
    e.add_configure(X, nlist=10, iter=3)
    return e


@pytest.mark.parametrize("plat,recall,hook,want", [
    ("cpu", 0.99, False, False),
    ("gpu", 0.99, False, True),
    ("gpu", None, False, False),   # bit-exact selection: no kernel
    ("cpu", 0.99, True, True),     # the interpret-mode test hook
    ("rocm", 0.99, False, False),  # no kernel for any other platform
])
def test_kernel_gate(small_engine, monkeypatch, plat, recall, hook, want):
    e = small_engine
    monkeypatch.setattr(rii_mod, "platform", lambda: plat)
    monkeypatch.setattr(e, "topk_recall", recall)
    monkeypatch.setattr(e, "pallas_interpret", hook, raising=False)
    assert e._use_replica_kernel(128) is want
    assert e._use_replica_kernel(96) is False  # non-power-of-two width


@pytest.mark.parametrize("plat,mode,budget,want", [
    ("cpu", "auto", None, "pq"),
    ("gpu", "auto", None, "bf16"),
    ("gpu", "auto", 1000, "pq"),      # replica does not fit the budget
    ("cpu", "bf16", None, "bf16"),
    ("gpu", "pq", None, "pq"),
    ("cpu", "int8", None, "bf16"),    # older checkpoints: int8 -> bf16
    ("gpu", "int8", None, "bf16"),
    ("gpu", "int8", 1000, "pq"),
])
def test_scan_mode_resolution(small_engine, monkeypatch, plat, mode, budget,
                              want):
    e = small_engine
    monkeypatch.setattr(rii_mod, "platform", lambda: plat)
    monkeypatch.setattr(e, "scan_mode", mode)
    monkeypatch.setattr(e, "decoded_cache_budget", budget)
    assert e._resolve_scan_mode(1024) == want


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 5}, 30 << 30),
    ({"bytes_in_use": 5}, 2 << 30),
    (None, 2 << 30),
    (RuntimeError("no allocator"), 2 << 30),
])
def test_default_cache_budget(stats, want):
    assert rii_mod.default_cache_budget(_FakeDevice(stats)) == want


def test_explicit_budget_overrides_device(small_engine, monkeypatch):
    e = small_engine
    monkeypatch.setattr(e, "decoded_cache_budget", 12345)
    assert e._cache_budget() == 12345
    monkeypatch.setattr(e, "decoded_cache_budget", None)
    assert e._cache_budget() == rii_mod.default_cache_budget()


@pytest.mark.parametrize("env,platforms,want", [
    ({}, "", "fixed"),
    ({}, None, "fixed"),
    ({}, "cpu", None),
    ({}, "cuda,cpu", "fixed"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "", None),
    ({"RII_TPU_NO_COMPILE_CACHE": "1"}, "", None),
])
def test_compile_cache_dir_choice(env, platforms, want):
    got = rii_tpu._compile_cache_dir(env, platforms)
    assert got == (rii_tpu.COMPILE_CACHE_DIR if want == "fixed" else want)
    # one fixed directory inside the checkout, never a temporary one
    assert rii_tpu.COMPILE_CACHE_DIR == os.path.join(_REPO, ".jax_cache")


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No GPU (or no package beside it): non-zero exit and no result line."""
    if where == "alone":
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = _REPO
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
