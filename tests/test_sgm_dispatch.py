"""The one SGM backend choice (ops/sgm_dispatch.py) and the compile
cache helper (utils/compile_cache.py)."""

import numpy as np
import pytest

import i3dr_stereo_tpu.ops.sgm_dispatch as dispatch
from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_4, sgm_aggregate
from i3dr_stereo_tpu.utils import compile_cache
from i3dr_stereo_tpu.utils.smoke import census_like_costs, sgm_backend


def test_cpu_auto_picks_reference(monkeypatch):
    monkeypatch.delenv("I3DR_SGM_BACKEND", raising=False)
    assert dispatch.resolve_backend() == "xla"
    assert dispatch.resolve_backend("cpu") == "xla"


def test_gpu_auto_picks_kernel(monkeypatch):
    monkeypatch.delenv("I3DR_SGM_BACKEND", raising=False)
    assert dispatch.resolve_backend("gpu") == "triton"


def test_env_forces_reference_on_gpu(monkeypatch):
    monkeypatch.setenv("I3DR_SGM_BACKEND", "xla")
    assert dispatch.resolve_backend("gpu") == "xla"


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setenv("I3DR_SGM_BACKEND", "pallas_t")
    with pytest.raises(ValueError, match="I3DR_SGM_BACKEND"):
        dispatch.resolve_backend("gpu")


def test_kernel_on_cpu_raises(monkeypatch):
    monkeypatch.setenv("I3DR_SGM_BACKEND", "triton")
    with pytest.raises(RuntimeError, match="no build"):
        dispatch.resolve_backend("cpu")


def test_gpu_without_kernel_raises(monkeypatch):
    """No silent fallback: a GPU the kernel is not built for is an error."""
    monkeypatch.delenv("I3DR_SGM_BACKEND", raising=False)
    monkeypatch.setattr(dispatch, "KERNEL_PLATFORMS", ())
    with pytest.raises(RuntimeError, match="no build"):
        dispatch.resolve_backend("gpu")


@pytest.mark.parametrize("backend", ["auto", "xla", "triton_interpret"])
def test_auto_entry_matches_reference(backend):
    C = census_like_costs((1, 6, 9, 8), seed=3)
    pens = ((3.0, 20.0), (4.0, 24.0), (5.0, 28.0), (6.0, 32.0))
    ref = np.asarray(sgm_aggregate(C, directions=DIRECTIONS_4,
                                   per_direction_penalties=pens))
    with sgm_backend(backend):
        got = np.asarray(dispatch.sgm_aggregate_auto(
            C, directions=DIRECTIONS_4, per_direction_penalties=pens))
    np.testing.assert_array_equal(got, ref)


def test_enable_cpu_switch_forces_reference(monkeypatch):
    from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM

    monkeypatch.delenv("I3DR_SGM_BACKEND", raising=False)
    eng = I3DRSGM()
    eng.enableCPU(True)
    assert dispatch.resolve_backend("gpu") == "xla"
    eng.enableCPU(False)
    assert dispatch.resolve_backend("gpu") == "triton"


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import os

    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
