"""The one backend decision (core/backend.py), the compile-cache location,
and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from mgl_tpu.core import backend

REPO = pathlib.Path(__file__).resolve().parents[1]


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("impl,platform,env,want", [
    ("auto", "cpu", None, "xla"),
    ("auto", "gpu", None, "pallas"),
    ("auto", "gpu", "xla", "xla"),       # MGL_TPU_IMPL=xla forces plain
    ("pallas", "cpu", None, "pallas"),   # an explicit impl is kept
    ("xla", "gpu", None, "xla"),
])
def test_resolve_impl(monkeypatch, impl, platform, env, want):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    if env is None:
        monkeypatch.delenv("MGL_TPU_IMPL", raising=False)
    else:
        monkeypatch.setenv("MGL_TPU_IMPL", env)
    assert backend.resolve_impl(impl) == want


def test_resolve_impl_rejects_unknown():
    from mgl_tpu.api import PairHmmEngine, SmithWatermanAligner

    with pytest.raises(ValueError):
        backend.resolve_impl("gpu")
    with pytest.raises(ValueError):
        SmithWatermanAligner(impl="mosaic")
    with pytest.raises(ValueError):
        PairHmmEngine(impl="mosaic")


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = backend.enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run_smoke(script: pathlib.Path, cwd: pathlib.Path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(ValueError):
        json.loads(last)


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(REPO / "chip_smoke.py", REPO)
    _assert_refused(proc)
    assert "not a GPU" in proc.stderr


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    _assert_refused(proc)
