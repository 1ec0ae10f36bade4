"""Content-keyed device residency for the fast engine's input payloads.

Repeated runs on one panel in one process (auto-winsize re-entry, API
parameter sweeps, services) find the 2-bit genotype payload, the weighted
aux planes and the small per-locus planes already in device memory instead
of uploading them again.  Keys are full-content digests (core/digest.py),
so distinct panels never alias.  Two LRUs bounded by bytes:
GARLIC_TPU_DEVICE_CACHE=<MB> sizes the payload cache (default 768, 0
disables); the plane cache gets 1/8 of it, capped at 64 MB, so plane
churn never evicts a genotype payload.
"""

from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from functools import partial

import numpy as np


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bucket(n: int) -> int:
    """Round n up to the next power of two (>= 8192): a genome's 22
    different chromosome lengths collapse to 1-3 compiled shapes for
    every jitted device op instead of one compilation per length, at the
    cost of < 2x padding."""
    return 1 << math.ceil(math.log2(max(n, 8192)))


def pack_genotypes(gp: np.ndarray) -> np.ndarray:
    """[I, L] int8 (0/1/2/-9) -> [I, L/4] u8 2-bit codes (L % 4 == 0,
    code 3 = missing, little-endian lanes).  4x fewer bytes than int8 —
    the panel-cache sidecar and the device payload both use this form.

    Packs in one C++ pass when the native lib is available: the numpy
    formulation allocates several full-size temporaries."""
    import ctypes

    from ..native.build import _load
    I, L = gp.shape
    lib = _load()
    if lib is not None:
        src = np.ascontiguousarray(gp, dtype=np.int8)
        out = np.empty((I, L // 4), dtype=np.uint8)
        lib.gt_pack_2bit(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            I * L)
        return out
    codes = np.where(gp == -9, 3, gp).astype(np.uint8)
    v = np.ascontiguousarray(codes).reshape(I, -1).view(np.uint32)
    packed = ((v & 0x3) | ((v >> 6) & 0xC) | ((v >> 12) & 0x30)
              | ((v >> 18) & 0xC0))
    return packed.astype(np.uint8)


@partial(__import__("jax").jit, static_argnames=("L", "L2"))
def _decode_2bit(p2, L: int, L2: int):
    """Device-side repad of a raw 2-bit packed [I, ceil(L/4)] genotype
    matrix to the bucketed [I, L2/4] input of the Phase-I program (tail
    lanes code 3 = missing).  The unpadded host bytes ship verbatim; the
    repad costs one cheap per-shape compile."""
    import jax.numpy as jnp

    I = p2.shape[0]
    d = p2.astype(jnp.int32)
    digs = [(d >> (2 * k)) & 3 for k in range(4)]
    g = jnp.stack(digs, axis=2).reshape(I, -1)[:, :L].astype(jnp.uint8)
    g = jnp.concatenate([g, jnp.full((I, L2 - L), 3, jnp.uint8)], axis=1)
    g4 = g.reshape(I, L2 // 4, 4)
    return (g4[..., 0] | (g4[..., 1] << 2) | (g4[..., 2] << 4)
            | (g4[..., 3] << 6))


def _ship_key(packed: np.ndarray, L: int):
    """Content key of a packed payload: shape + L + a full-content
    digest.  The cache outlives one pipeline run, so the key must be
    collision-safe across different panels, not just across configs of
    one panel — hence the full bytes, not a strided sample."""
    from ..core.digest import content_digest
    return (packed.shape, L, content_digest(packed))


def _chrom_key(chrom):
    """Cache key for a packed-only chromosome WITHOUT touching its
    (possibly still unmaterialized) packed bytes: derived from the
    panel-cache sidecar digest carried through the filter.  None when no
    digest is known (fresh parse, legacy sidecar, row-subset) — callers
    then hash the materialized payload."""
    if not chrom.geno_is_packed_only:
        return None
    from ..core.digest import ship_key_from_digest
    return ship_key_from_digest(chrom.nind, chrom.nloci,
                                chrom.geno2b_digest)


_lock = threading.Lock()
_device_cache: "OrderedDict" = OrderedDict()
_device_cache_bytes = 0
_device_cache_hits = 0  # diagnostic (tests)
_plane_cache: "OrderedDict" = OrderedDict()
_plane_cache_bytes = 0


def _device_cache_budget() -> int:
    try:
        mb = float(os.environ.get("GARLIC_TPU_DEVICE_CACHE", "768"))
    except ValueError:
        mb = 768.0
    return max(0, int(mb * (1 << 20)))


def _entry_nbytes(entry) -> int:
    return sum(int(getattr(a, "nbytes", 0)) for a in entry[1:])


def _device_cache_get(key):
    global _device_cache_hits
    with _lock:
        e = _device_cache.pop(key, None)
        if e is not None:
            _device_cache[key] = e  # LRU bump
            _device_cache_hits += 1
        return e


def _device_cache_put(key, entry) -> None:
    global _device_cache_bytes
    budget = _device_cache_budget()
    n = _entry_nbytes(entry)
    if budget <= 0 or n > budget:
        return
    with _lock:
        if key in _device_cache:
            return
        while _device_cache and _device_cache_bytes + n > budget:
            _, old = _device_cache.popitem(last=False)
            _device_cache_bytes -= _entry_nbytes(old)
        _device_cache[key] = entry
        _device_cache_bytes += n


def clear_device_cache() -> None:
    global _device_cache_bytes, _plane_cache_bytes
    with _lock:
        _device_cache.clear()
        _device_cache_bytes = 0
        _plane_cache.clear()
        _plane_cache_bytes = 0


def _device_plane(plane: np.ndarray):
    """Content-keyed device residency for small per-locus input planes
    (the LOD table, the window-missing mask): identical bytes return the
    identical device buffer, so a warm run uploads nothing.  Budget: 1/8
    of the payload cache's, capped at 64 MB, in its own LRU."""
    import jax.numpy as jnp

    global _plane_cache_bytes
    budget = min(_device_cache_budget() // 8, 64 << 20)
    if budget <= 0 or plane.nbytes > budget:
        return jnp.asarray(plane)
    from ..core.digest import content_digest
    key = (plane.dtype.str, plane.shape, content_digest(plane))
    with _lock:
        hit = _plane_cache.pop(key, None)
        if hit is not None:
            _plane_cache[key] = hit  # LRU bump
            return hit
    arr = jnp.asarray(plane)
    with _lock:
        if key not in _plane_cache:
            while _plane_cache and _plane_cache_bytes + arr.nbytes > budget:
                _, old = _plane_cache.popitem(last=False)
                _plane_cache_bytes -= old.nbytes
            _plane_cache[key] = arr
            _plane_cache_bytes += arr.nbytes
    return arr


def _packed_2bit(chrom):
    """[I, ceil(L/4)] 2-bit genotype bytes (reuse the panel-cache packing
    when the chromosome is packed-only; otherwise pack the int8 view)."""
    if chrom.geno_is_packed_only:
        return chrom.geno2b
    g = np.asarray(chrom.genotypes)
    I, L = g.shape
    Lp = -(-L // 4) * 4
    if Lp != L:
        gp = np.full((I, Lp), -9, np.int8)
        gp[:, :L] = g
        g = gp
    return pack_genotypes(np.ascontiguousarray(g))


def device_packed_keyed(chrom):
    """Device-resident [I, ceil(L/4)] 2-bit genotype bytes from the
    content-addressed cache (uploaded on a miss).  Returns (device array,
    content key) so callers can derive further cache keys (aux planes)
    from the same genotype-content identity.  With a sidecar-derived key
    (_chrom_key) a hit never materializes the host bytes."""
    import jax.numpy as jnp

    key = _chrom_key(chrom)
    if key is not None:
        hit = _device_cache_get(key)
        if hit is not None:
            return hit[1], key
    packed = _packed_2bit(chrom)
    if key is None:
        key = _ship_key(packed, chrom.nloci)
        hit = _device_cache_get(key)
        if hit is not None:
            return hit[1], key
    arr = jnp.asarray(np.ascontiguousarray(packed))
    _device_cache_put(key, ("2b", arr))
    return arr, key
