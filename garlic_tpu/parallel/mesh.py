"""Device-mesh construction for the ROH engine.

The reference's only parallelism is pthreads over locus ranges inside one
process (src/garlic-roh.cpp:184-194, src/garlic-data.cpp:404-414).  The
device scaling story replaces that with a 2-D logical mesh:

* ``dp`` — data parallelism over **individuals** (the primary shard axis:
  every per-individual computation in the pipeline is embarrassingly
  parallel across this axis; allele-frequency numerators/denominators, KDE
  partial sums and GMM sufficient statistics are merged with ``psum``).
* ``sp`` — sequence parallelism over **loci** along a chromosome (windows
  straddling a shard boundary need a (winsize-1)-locus halo pulled from the
  right neighbor via ``ppermute`` — ring-attention's neighbor exchange
  applied to a window scan).

Shardings ride ICI within a slice and DCN across hosts automatically when
the mesh is built over `jax.devices()` in default order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

AXIS_DP = "dp"
AXIS_SP = "sp"


def factor_devices(n: int, max_sp: int = 4) -> Tuple[int, int]:
    """Pick a (dp, sp) factorization of n devices.

    dp (individuals) is the primary axis — it scales without communication —
    so sp only grows when dp alone cannot use the devices or when asked."""
    sp = 1
    for cand in range(min(max_sp, n), 0, -1):
        if n % cand == 0:
            sp = cand
            break
    return n // sp, sp


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
              devices: Optional[Sequence] = None):
    """Build a ("dp", "sp") jax.sharding.Mesh.

    With no arguments: all visible devices on the dp axis."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_sp
    if n_dp * n_sp > n:
        raise ValueError(f"mesh {n_dp}x{n_sp} exceeds {n} devices")
    devs = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devs, (AXIS_DP, AXIS_SP))
