"""The engine choice, the compile-cache location, and the GPU kernel itself.

The choice of march engine is one predicate keyed on the platform
(ops.use_march_kernel); every router (trace_auto, the sharded programs,
the perf harnesses) asks it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu.config import DEFAULT_CACHE_DIR, compilation_cache_dir
from raytrace_tpu.destinations import (
    DiscWithISCO,
    FlatPlane,
    RadialVelocityField,
    SphericalShell,
    ThetaLimit,
)
from raytrace_tpu.ops import use_march_kernel

KERNEL_DESTS = [
    None,
    ThetaLimit(jnp.pi / 2),
    DiscWithISCO(r_isco=1.24, r_out=30.0),
    FlatPlane(incl=1.0),
    SphericalShell(r_shell=40.0),
]


@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
@pytest.mark.parametrize("dest", KERNEL_DESTS, ids=lambda d: type(d).__name__)
def test_gpu_routes_to_kernel(method, dest):
    assert use_march_kernel(method, dest, platform="gpu")


def test_gpu_velocity_field_takes_xla_path():
    assert not use_march_kernel("rk45", RadialVelocityField(v=0.1), platform="gpu")


@pytest.mark.parametrize("dest", KERNEL_DESTS, ids=lambda d: type(d).__name__)
def test_cpu_takes_xla_path(dest):
    assert not use_march_kernel("rk45", dest, platform="cpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(platform):
    with pytest.raises(RuntimeError, match="no march engine"):
        use_march_kernel("rk4", None, platform=platform)


def test_default_platform_is_the_first_device():
    # the suite runs on CPU (conftest), so the default choice is XLA
    assert jax.devices()[0].platform == "cpu"
    assert not use_march_kernel("rk45")


def test_trace_auto_on_cpu_is_trace_compacted():
    from raytrace_tpu.ops import trace_auto, trace_compacted
    from raytrace_tpu.sources import PointSourceGrid, point_source

    grid = PointSourceGrid.from_steps(0.6, 1.2, -0.9, 0.9, -3.0, 3.0)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=0.9, grid=grid)
    kw = dict(method="rk4", r_max=100.0, steplim=2000)
    a = trace_auto(rays, 0.9, **kw)
    b = trace_compacted(rays, 0.9, **kw)
    assert a.r.dtype == jnp.float64
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilation_cache_dir() == str(DEFAULT_CACHE_DIR)
    assert DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (DEFAULT_CACHE_DIR.parent / "raytrace_tpu" / "config.py").exists()


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache_dir() == str(tmp_path)


def test_enable_cache_sets_no_dir_when_environment_does(monkeypatch, tmp_path):
    from raytrace_tpu.config import enable_compilation_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("RT_COMPCACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    enable_compilation_cache()
    assert "jax_compilation_cache_dir" not in dict(calls)
    calls.clear()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    enable_compilation_cache()
    assert dict(calls)["jax_compilation_cache_dir"] == str(DEFAULT_CACHE_DIR)
    calls.clear()
    monkeypatch.setenv("RT_COMPCACHE", "0")
    enable_compilation_cache()
    assert calls == []


@pytest.mark.gpu
def test_gpu_kernel_matches_xla_route():
    """Compile the real Triton kernel and hold it to the XLA route with
    chip_smoke's statistical gates (status agreement, median |dr|/r, no
    stuck rays). Runs where JAX's first device is a GPU:
    ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel has no CPU lowering")
    import chip_smoke
    from raytrace_tpu.ops import trace_compacted
    from raytrace_tpu.ops.pallas_kernel import trace_pallas_fused

    rays = chip_smoke.lamppost_f32(0.05, 0.05)
    s = jnp.float32(0.998)
    live = np.asarray(rays.steps) >= 0
    for method in ("rk4", "rk45"):
        kw = dict(method=method, r_max=1000.0, steplim=40_000)
        a = trace_pallas_fused(rays, s, **kw)
        b = trace_compacted(rays, s, **kw)
        res = chip_smoke.engine_agreement(a.status, a.r, b.status, b.r, live)
        assert res["ok"], (method, res)
