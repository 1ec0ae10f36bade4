"""Device runtime helpers for the fast engine."""

from __future__ import annotations

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILE_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def accelerator() -> str:
    """Platform of the device the fast engine runs on ("gpu", "cpu", ...).

    The one backend decision of the package: engine resolution, the
    fused coverage kernel and the memory budget all read it."""
    import jax
    return jax.devices()[0].platform


class PhaseProfiler:
    """Per-phase wall-clock + throughput counters (--tpu-profile).

    The reference has no tracing at all (SURVEY.md §5); this is the
    observability layer the BASELINE windows/s metric needs.  mark()
    closes the current phase; report() prints a summary to stderr.  When
    GARLIC_TPU_TRACE_DIR is set, a JAX profiler trace covers the run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.phases = []
        self._t0 = time.perf_counter()
        self._trace = None
        if enabled:
            tdir = os.environ.get("GARLIC_TPU_TRACE_DIR")
            if tdir:
                import jax
                self._trace = jax.profiler.trace(tdir)
                self._trace.__enter__()

    def mark(self, name: str, items: float = 0.0, unit: str = ""):
        if not self.enabled:
            return
        now = time.perf_counter()
        self.phases.append((name, now - self._t0, items, unit))
        self._t0 = now

    def report(self):
        if not self.enabled:
            return
        if self._trace is not None:
            self._trace.__exit__(None, None, None)
            self._trace = None
        total = sum(p[1] for p in self.phases)
        print("[profile] phase breakdown:", file=sys.stderr)
        for name, dt, items, unit in self.phases:
            rate = f"  ({items / dt:,.0f} {unit}/s)" if items and dt > 0 \
                else ""
            print(f"[profile]   {name:<18} {dt:8.3f}s{rate}",
                  file=sys.stderr)
        print(f"[profile]   {'TOTAL':<18} {total:8.3f}s", file=sys.stderr)


CPU_HBM_BUDGET = 8 * 1024 ** 3  # bytes


def hbm_budget() -> float:
    """Usable device-memory bytes for device-resident window/score planes.

    `GARLIC_TPU_HBM_BUDGET` (raw BYTES; floats like `2e9` accepted)
    overrides; else 90% of the device's reported bytes_limit; else 8 GiB
    on the CPU backend (test runs, where memory_stats is unavailable).
    An accelerator whose memory cannot be read is an error, not a
    default.  Shared by the pipeline's per-chromosome streaming gate and
    the weighted Phase-I fused-vs-chunked router so one env knob means
    one budget everywhere."""
    v = os.environ.get("GARLIC_TPU_HBM_BUDGET")
    if v:
        return float(v)
    import jax
    dev = jax.local_devices()[0]
    ms = dev.memory_stats()
    if ms and ms.get("bytes_limit"):
        return 0.9 * float(ms["bytes_limit"])
    if dev.platform == "cpu":
        return float(CPU_HBM_BUDGET)
    raise RuntimeError(
        f"cannot read the memory limit of {dev.platform} device "
        f"{dev.device_kind!r}; set GARLIC_TPU_HBM_BUDGET (bytes)")


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent).

    JAX_COMPILATION_CACHE_DIR, when set, names the cache and nothing
    here overrides it; otherwise the cache lives at a fixed path inside
    the checkout (`.jax_cache`, git-ignored), so every process of one
    checkout shares it.  GARLIC_TPU_NO_COMPILE_CACHE disables."""
    if os.environ.get("GARLIC_TPU_NO_COMPILE_CACHE"):
        return
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
