"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The numerics tests pin f64 on the CPU and the sharding tests need 8
devices, so the CPU backend with 8 virtual devices is the default, set
before any test touches a jax array. Tests of the real GPU kernel carry the
``gpu`` marker and skip on the CPU; on a card they run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Keep the persistent compilation cache out of the suite: app mains invoked
# in-process would otherwise enable it. Hermetic tests recompile.
os.environ["RT_COMPCACHE"] = "0"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402


def pytest_sessionstart(session):
    if os.environ["JAX_PLATFORMS"] != "cpu":
        return
    # Fail fast if the CPU setting did not take.
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}"
    )
    assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Release compiled executables between test modules.

    The suite is one process compiling hundreds of XLA:CPU programs
    (every app main in the CLI sweep jits its own); holding all of them
    alive for the whole run both bloats RSS and has produced a
    late-suite segfault inside backend_compile_and_load. Modules don't
    share program shapes, so clearing costs only the next module's
    (already-counted) compiles.
    """
    yield
    import jax

    jax.clear_caches()
