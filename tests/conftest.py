"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Tests validate correctness and multi-device sharding semantics on host CPU
devices.  ``JAX_PLATFORMS`` defaults to ``cpu``; tests marked ``gpu`` need a
card and run with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``
(the ``gpu`` fixture skips them when JAX finds no GPU).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already have been imported by a pytest plugin; the backend is
# initialized lazily, so setting the platform via config still works here.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)

# NOTE: do NOT enable the persistent compilation cache here — XLA:CPU AOT
# blobs are machine-feature-sensitive and loading them can SIGSEGV/SIGILL
# ("Compile machine features ... vs host machine features" loader errors).


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU has crashed (SIGSEGV) deep into long suite runs with hundreds
    of live compiled executables; dropping them between modules keeps the
    native runtime state small.  Individual modules recompile what they need."""
    yield
    import jax

    jax.clear_caches()
