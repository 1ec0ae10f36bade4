"""Multi-host (pod-slice) runtime initialization.

The reference is a single process (SURVEY.md §2: no multi-process/
multi-node story).  Scaling past one host uses the standard JAX
multi-controller runtime: every host runs the same program,
`jax.distributed.initialize` wires the hosts together, and the
("dp", "sp") mesh in mesh.py spans all hosts' devices — collectives run
over the intra-host interconnect and the cluster network automatically.

Typical launch (one process per host):

    GARLIC_TPU_COORD=host0:8476 GARLIC_TPU_NUM_PROCS=4 \\
    GARLIC_TPU_PROC_ID=$SLURM_PROCID \\
    python -m garlic_tpu --tped ... --tpu-engine fast --tpu-mesh 16x2

Host-sharded input: on eligible runs (fast engine + mesh, unweighted —
TGLS included) the pipeline computes this host's genotype column range
before the parse and each process loads ONLY its own dp-row block
(native column-range parser / .gtpc/.gtlc row slices) — host RAM scales
1/num_hosts and the global allele freqs come from
allele_freq_counts_sharded's psum.  Weighted runs DELIBERATELY keep the
replicated full parse: their tie patrol re-derives suspect windows
against the exact full-panel LD band host-side, which per-host rows
cannot provide without heavy pair-count gathers — compute still shards
over the mesh (ld_band_sharded psums the pair counts), only host RAM
stays O(panel).  `host_individual_range` computes the contiguous dp
slice either way.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

_initialized = False


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Idempotent jax.distributed.initialize wrapper.

    Resolution order: explicit args > GARLIC_TPU_COORD /
    GARLIC_TPU_NUM_PROCS / GARLIC_TPU_PROC_ID env vars > JAX autodetect.
    Returns True when a multi-process runtime is active."""
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1
    coordinator = coordinator or os.environ.get("GARLIC_TPU_COORD")
    num_str = os.environ.get("GARLIC_TPU_NUM_PROCS")
    pid_str = os.environ.get("GARLIC_TPU_PROC_ID")
    num_processes = num_processes if num_processes is not None else (
        int(num_str) if num_str else None)
    process_id = process_id if process_id is not None else (
        int(pid_str) if pid_str else None)
    if coordinator or num_processes or process_id is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    else:
        try:
            jax.distributed.initialize()
        except Exception:
            # single-process (no cluster env detected)
            _initialized = True
            return False
    _initialized = True
    return jax.process_count() > 1


def host_individual_range(nind: int) -> Tuple[int, int]:
    """This host's contiguous [start, stop) slice of the individual axis
    when inputs are sharded per-host (dp-major block distribution)."""
    import jax

    p = jax.process_count()
    i = jax.process_index()
    per = -(-nind // p)
    start = min(i * per, nind)
    return start, min(start + per, nind)


def initialize_from_env() -> Tuple[int, int]:
    """Pipeline entry hook: wire the multi-controller runtime when the
    GARLIC_TPU_COORD / GARLIC_TPU_NUM_PROCS / GARLIC_TPU_PROC_ID env vars
    are present (each host runs the same garlic-tpu command; the mesh then
    spans every host's devices over DCN).  Returns (process_count,
    process_index) — (1, 0) when no cluster env is configured."""
    import jax

    if not (os.environ.get("GARLIC_TPU_COORD")
            or os.environ.get("GARLIC_TPU_NUM_PROCS")):
        return 1, 0
    initialize_distributed()
    return jax.process_count(), jax.process_index()


def to_host(x) -> "np.ndarray":
    """Device->host transfer that works for multi-process global arrays.

    np.asarray on a jax.Array whose shards live on other hosts' devices
    raises; gather them over DCN first (every process receives the full
    array, mirroring the reference's single-address-space WinData)."""
    import numpy as np

    import jax

    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def put_dp_sharded(arr, mesh, sharding, local_block: bool = False):
    """Place a host [I2, L2] array onto the mesh, feeding only THIS host's
    dp-row block when the device layout is row-aligned (each host then
    ships 1/num_hosts of the bytes; with per-host input shards the other
    rows never need to exist host-side at all).  Falls back to a plain
    device_put (full transfer, JAX scatters local shards) otherwise.

    local_block=True: `arr` already IS this host's dp-row block (per-host
    column-range input, [I2/num_hosts, L2]) — no slicing, no fallback
    (the pipeline only enables sharded loading on row-aligned layouts)."""
    import jax

    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    import numpy as np
    if local_block:
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(arr))
    from .mesh import AXIS_SP
    d = jax.local_device_count()
    n_sp = mesh.shape[AXIS_SP]
    if d % n_sp != 0 or arr.ndim != 2:
        return jax.device_put(arr, sharding)
    start, stop = host_individual_range(arr.shape[0])
    local = np.ascontiguousarray(arr[start:stop])
    return jax.make_array_from_process_local_data(sharding, local)


def dp_layout_aligned(mesh) -> bool:
    """True when every host's devices form whole dp rows of `mesh` (the
    condition for per-host dp-row blocks: local_device_count divides into
    complete sp rows and the dp extent splits evenly over processes)."""
    import jax

    from .mesh import AXIS_DP, AXIS_SP
    d = jax.local_device_count()
    n_sp = mesh.shape[AXIS_SP]
    n_dp = mesh.shape[AXIS_DP]
    p = jax.process_count()
    return d % n_sp == 0 and n_dp % p == 0 and n_dp * n_sp == d * p
