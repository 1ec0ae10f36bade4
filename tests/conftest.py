"""Test configuration: force JAX onto a virtual 8-device CPU mesh so sharding
logic is exercised without accelerator hardware (SURVEY.md §4).  Tests that
need a GPU carry the `gpu` marker and skip here from inside the test."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") +
    " --xla_force_host_platform_device_count=8").strip()
# No persistent XLA compile cache under pytest: writing a cache entry
# calls PJRT executable.serialize(), which segfaults the CPU backend
# after ~30 large in-process compilations (observed in long fuzz
# campaigns; crash stack ends in jax compilation_cache
# put_executable_and_time).  The cache only helps cross-process device
# startup; in-process jit caching is unaffected.
os.environ.setdefault("GARLIC_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

# CPU unless the caller names a platform (`JAX_PLATFORMS=cuda` runs the
# `gpu`-marked tests on a GPU host)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pytest  # noqa: E402

ORACLE = "/root/reference/bin/linux/garlic"


@pytest.fixture(scope="session")
def oracle_bin():
    if not os.path.exists(ORACLE) or not os.access(ORACLE, os.X_OK):
        pytest.skip("reference oracle binary unavailable")
    return ORACLE
