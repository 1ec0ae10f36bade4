"""The backend decision, the device-memory budget and the compile-cache
placement (garlic_tpu/runtime.py)."""

from __future__ import annotations

import os
import types

import pytest

import jax

from garlic_tpu import runtime


def test_accelerator_reports_first_device_platform():
    assert runtime.accelerator() == jax.devices()[0].platform == "cpu"


def _fake_device(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind="fake",
                                 memory_stats=lambda: stats)


@pytest.mark.parametrize("platform,stats,env,want", [
    ("gpu", {"bytes_limit": 1000}, None, 900.0),   # 90% of the limit
    ("cpu", None, None, float(runtime.CPU_HBM_BUDGET)),
    ("gpu", None, "2e9", 2e9),                     # env override wins
    ("gpu", {}, None, RuntimeError),               # unreadable accelerator
])
def test_hbm_budget(monkeypatch, platform, stats, env, want):
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_fake_device(platform, stats)])
    if env is None:
        monkeypatch.delenv("GARLIC_TPU_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", env)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="GARLIC_TPU_HBM_BUDGET"):
            runtime.hbm_budget()
    else:
        assert runtime.hbm_budget() == want


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache settings after the test (no compile
    runs while they point anywhere)."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(monkeypatch, tmp_path, cache_config,
                                 env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing here
    overrides it; unset, the cache is the fixed path in the checkout."""
    monkeypatch.delenv("GARLIC_TPU_NO_COMPILE_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(runtime, "COMPILE_CACHE_DIR",
                            str(tmp_path / ".jax_cache"))
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
    runtime.enable_compile_cache()
    if env_dir is None:
        assert jax.config.jax_compilation_cache_dir == \
            str(tmp_path / ".jax_cache")
        assert os.path.isdir(tmp_path / ".jax_cache")
    else:
        assert jax.config.jax_compilation_cache_dir is None
        assert not os.path.exists(tmp_path / ".jax_cache")


def test_compile_cache_default_is_inside_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.COMPILE_CACHE_DIR == os.path.join(repo, ".jax_cache")


def test_compile_cache_can_be_disabled(monkeypatch, cache_config):
    monkeypatch.setenv("GARLIC_TPU_NO_COMPILE_CACHE", "1")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    runtime.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir is None
