"""Test configuration.

Forces JAX onto a virtual CPU mesh *before* jax is imported anywhere, so
sharding/multi-device tests run without an accelerator.  GPU kernels run
on CPU only where a test passes ``interpret=True``; tests marked ``gpu``
need a card and skip here (see the ``gpu_device`` fixture).
"""

import os

# Must happen before any jax import in the test session.  The GPU parity
# tests run with JAX_PLATFORMS=cuda set by the caller.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import json  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def pairhmm_kat():
    """105 known-answer cases (104 reference data-file rows + simpleTest)."""
    return json.loads((GOLDEN / "pairhmm_kat.json").read_text())


@pytest.fixture(scope="session")
def sw_golden():
    """~2000 SW cases with golden CIGAR/offset from the compiled reference."""
    return [json.loads(l) for l in (GOLDEN / "sw_golden.jsonl").read_text().splitlines()]


@pytest.fixture(scope="session")
def pairhmm_golden():
    """225 PairHMM cases with hex-exact scores from all 4 reference kernels."""
    return [json.loads(l) for l in (GOLDEN / "pairhmm_golden.jsonl").read_text().splitlines()]


def as_u8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def kat_read(case: dict) -> dict:
    return dict(
        bases=as_u8(case["read"]),
        q=np.array(case["q"], dtype=np.uint8),
        i=np.array(case["i"], dtype=np.uint8),
        d=np.array(case["d"], dtype=np.uint8),
        c=np.array(case["c"], dtype=np.uint8),
    )


@pytest.fixture
def gpu_device():
    """JAX's default device when it is a GPU; skips the test otherwise.

    Tests marked ``gpu`` take this fixture, so the decision is made when
    the test runs, never while modules are imported.  On a machine with a
    card: ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q``.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
