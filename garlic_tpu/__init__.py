"""garlic_tpu: a device-accelerated runs-of-homozygosity (ROH) calling engine.

Re-implements the capabilities of GARLIC (szpiech/garlic v1.1.6a) —
four-phase Pemberton/Blant ROH pipeline, all I/O formats, CLI and output
byte-compatibility — as a JAX/XLA/Pallas engine that runs on a GPU and
shards individuals data-parallel over a device mesh.
"""

import os as _os

_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")


def _disable_numpy_thp() -> None:
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    On this class of virtualized host, THP faults are ~50-100x slower
    than plain 4k faults (a fresh 25 MB np.empty + first touch measured
    3.4 s vs 47 ms) — the single largest host-side cost in the cached
    pipeline.  The env var only works before numpy initializes, so also
    flip the runtime switch for embedders that import numpy first."""
    try:
        import numpy as _np
        _ma = getattr(_np, "_core", getattr(_np, "core", None))
        _ma.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass


_disable_numpy_thp()

from .version import __version__, OUTPUT_COMPAT_VERSION

__all__ = ["__version__", "OUTPUT_COMPAT_VERSION"]
