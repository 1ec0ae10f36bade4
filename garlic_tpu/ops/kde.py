"""Phase II: Gaussian KDE of the pooled LOD distribution.

Reproduces computeKDE (src/garlic-kde.cpp:14-140): Silverman nrd0 bandwidth,
512 equally spaced targets over [min-3h, max+3h] (targets start one spacing
above the extended min), Gauss transform G(t) = sum_j q_j exp(-(x_j-t)^2/h^2)
with q_j = 1/n (the FIGTree kernel convention, include/figtree.h:154-235),
then normalization to integrate to 1.

The reference approximates the transform with FIGTree at eps=1e-2; on the
device the exact dense transform is a trivially parallel [N x 512]
elementwise+reduce, so no approximation is needed — we compute it exactly,
blocked over sources, in float64 on host or float32 on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import MISSING


_block_bufs = {}
_device_block = None


def _device_gauss_block():
    """Jitted partial Gauss transform block, compiled ONCE per process.

    The bandwidth enters as a traced argument (inv_h2), not a closure
    constant: winsize searches call gauss_transform with a fresh h every
    iteration, and a captured h would retrace/recompile each time."""
    global _device_block
    if _device_block is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def _block(src, tgt, inv_h2):
            d = src[:, None] - tgt[None, :]
            return jnp.sum(jnp.exp(-(d * d) * inv_h2), axis=0)

        _device_block = _block
    return _device_block


@dataclass
class KDEResult:
    x: np.ndarray  # [512] float64 targets
    y: np.ndarray  # [512] float64 normalized density

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def clone(self) -> "KDEResult":
        return KDEResult(self.x.copy(), self.y.copy())


def nrd0(data: np.ndarray) -> float:
    """Silverman's rule-of-thumb bandwidth (src/garlic-kde.cpp:130-140):
    0.9 * min(sd, IQR/1.34) * N^(-1/5), with GSL's linear-interpolated
    quantiles on sorted data.

    The sd must be BIT-identical to gsl_stats_sd: the KDE grid origin is
    min - 3h, so the sd feeds every .kde x value (a declared comparison
    artifact).  GSL accumulates both running-mean recurrences in 80-bit
    x87 extended precision (verified by disassembling the oracle binary);
    np.std's pairwise f64 summation differs in the last ulps, which the
    %g-printed grid exposes.  Native gt_gsl_sd replicates the exact op
    sequence; the fallback runs the same recurrence via np.longdouble."""
    x = np.sort(np.asarray(data, dtype=np.float64))
    n = x.shape[0]
    hi = _gsl_sd_sorted(x)
    q75 = _gsl_quantile_sorted(x, 0.75)
    q25 = _gsl_quantile_sorted(x, 0.25)
    iqr = q75 - q25
    lo = min(hi, iqr / 1.34)
    return 0.9 * lo * float(n) ** -0.2


def _gsl_sd_sorted(x: np.ndarray) -> float:
    """gsl_stats_sd on (already sorted) f64 data — see nrd0."""
    from ..native import gsl_sd_native
    s = gsl_sd_native(x)
    if s is not None:
        return s
    n = x.shape[0]
    if n < 2:
        return 0.0
    # Pure-Python mirror of gt_gsl_sd: np.longdouble is the same 80-bit
    # x87 format on x86-64 Linux.  O(n) Python-loop fallback — the native
    # path is the production one.
    mean = np.longdouble(0.0)
    for i in range(n):
        mean += (np.longdouble(x[i]) - mean) / np.longdouble(i + 1)
    mean_d = np.float64(mean)
    var = np.longdouble(0.0)
    for i in range(n):
        delta = np.float64(x[i] - mean_d)
        var += (np.longdouble(delta) * np.longdouble(delta) - var) \
            / np.longdouble(i + 1)
    var_d = np.float64(var)
    return float(np.sqrt(np.float64(n) / np.float64(n - 1) * var_d))


def _gsl_quantile_sorted(x: np.ndarray, f: float) -> float:
    """gsl_stats_quantile_from_sorted_data: index h=(N-1)f, linear interp."""
    n = x.shape[0]
    idx = (n - 1) * f
    lhs = int(idx)
    delta = idx - lhs
    if lhs == n - 1:
        return float(x[lhs])
    return float((1 - delta) * x[lhs] + delta * x[lhs + 1])


def gauss_transform(sources: np.ndarray, targets: np.ndarray, h: float,
                    device: bool = False) -> np.ndarray:
    """sum_j (1/n) exp(-(x_j - t)^2 / h^2) for each target.

    device=True runs blocked float32 on the default JAX device;
    otherwise blocked float64 numpy on host."""
    n = sources.shape[0]
    q = 1.0 / float(n)
    if device:
        out = np.zeros(targets.shape[0], dtype=np.float64)
        src = np.asarray(sources, dtype=np.float32)
        tgt = np.asarray(targets, dtype=np.float32)
        block = _device_gauss_block()
        inv_h2 = np.float32(1.0 / (h * h))
        step = 1 << 20
        # dispatch every block, then fetch: each [512] partial is tiny
        # but a SYNCHRONOUS per-block fetch pays one device round trip
        # per block; async copies overlap the uploads/compute and the
        # host-side
        # f64 accumulation order (block order) is unchanged — bitwise
        # identical y.
        devs = []
        for s in range(0, n, step):
            blk = src[s:s + step]
            k = blk.shape[0]
            if k < step:
                # bucket short blocks to the next power of two so a winsize
                # search (fresh sample count each iteration) reuses a handful
                # of compiles: sentinel sources square to inf in f32 ->
                # exp(-inf) = 0, contributing nothing
                b = 1 << max(k - 1, 1).bit_length()
                blk = np.concatenate(
                    [blk, np.full(b - k, 1e30, dtype=np.float32)])
            devs.append(block(blk, tgt, inv_h2))
        for d in devs:
            try:
                d.copy_to_host_async()
            except AttributeError:
                pass
        for d in devs:
            out += np.asarray(d, dtype=np.float64)
        return out * q
    m = targets.shape[0]
    out = np.zeros(m, dtype=np.float64)
    t = targets[None, :]
    inv_h2 = 1.0 / (h * h)
    step = 1 << 13
    # one reused block buffer, all ops in place: per-block temporaries at
    # WGS sample counts are hundreds of MB of fresh pages each, which this
    # VM faults at ~10 MB/s; cached across calls (winsize searches call
    # repeatedly)
    key = (min(step, n), m)
    buf = _block_bufs.get(key)
    if buf is None:
        buf = np.empty(key, dtype=np.float64)
        _block_bufs[key] = buf
    for s in range(0, n, step):
        k = min(step, n - s)
        b = buf[:k]
        np.subtract(sources[s:s + k, None], t, out=b)
        np.multiply(b, b, out=b)
        b *= -inv_h2
        # clamp at -700: exp(-700) ~ 1e-304 is still a normal double, so no
        # subnormal results are produced (x86 FP-assist traps on subnormals
        # make the unclamped version ~50x slower); the 1e-304 floor is
        # invisible at the .kde file's %g precision
        np.maximum(b, -700.0, out=b)
        np.exp(b, out=b)
        out += b.sum(axis=0)
    return out * q


_kde_flat_jit = None


def _kde_flat_factory():
    """In-graph Phase II: valid-mask -> sort -> nrd0 (f64) -> grid ->
    blocked f32 Gauss transform -> normalize, in ONE jit.  Sample pooling,
    bandwidth statistics, and the transform never leave the device; only
    [targets(512), y(512), n] f64 returns over the link (vs the former
    D2H of every thinned sample + H2D re-upload for the transform —
    10s of MB each way on WGS panels at 10-40 MB/s).

    Numerics: the bandwidth/grid math mirrors nrd0 /
    _gsl_quantile_sorted in f64 (differences vs the host path are
    summation-order only, ~1e-15 relative); the transform keeps the f32
    block scheme of gauss_transform(device=True), padding with 1e30
    (squares to inf -> exp contributes exactly 0)."""
    global _kde_flat_jit
    if _kde_flat_jit is None:
        from functools import partial

        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("block",))
        def _kde_flat(flat, block: int):
            valid = (flat != jnp.float32(MISSING)) & ~jnp.isnan(flat)
            ni = valid.sum().astype(jnp.int32)
            n = ni.astype(jnp.float64)
            xs = jnp.sort(jnp.where(valid, flat, jnp.inf))
            x64 = xs.astype(jnp.float64)
            fin = jnp.isfinite(x64)
            mean = jnp.where(fin, x64, 0.0).sum() / n
            var = jnp.where(fin, (x64 - mean) ** 2, 0.0).sum() / (n - 1.0)
            sd = jnp.sqrt(var)
            last = jnp.maximum(ni - 1, 0)

            def q(p):
                idx = (n - 1.0) * p
                lhs = jnp.floor(idx).astype(jnp.int32)
                delta = idx - lhs.astype(jnp.float64)
                lo = x64[lhs]
                hi = x64[jnp.minimum(lhs + 1, last)]
                return jnp.where(lhs == last, lo,
                                 (1.0 - delta) * lo + delta * hi)

            iqr = q(0.75) - q(0.25)
            h = 0.9 * jnp.minimum(sd, iqr / 1.34) * n ** -0.2
            CUT, M = 3.0, 512
            mn = x64[0] - CUT * h
            mx = x64[last] + CUT * h
            i = jnp.arange(1, M + 1, dtype=jnp.float64)
            targets = (i / M) * (mx - mn) + mn
            spacing = targets[1] - targets[0]
            tgtf = targets.astype(jnp.float32)
            inv_h2 = (1.0 / (h * h)).astype(jnp.float32)
            src = jnp.where(valid, flat, jnp.float32(1e30))
            src = src.reshape(-1, block)

            def body(acc, blk):
                d = blk[:, None] - tgtf[None, :]
                return acc + jnp.sum(jnp.exp(-(d * d) * inv_h2),
                                     axis=0).astype(jnp.float64), None

            y, _ = jax.lax.scan(body, jnp.zeros(M, jnp.float64), src)
            y = y / n
            y = y / (y.sum() * spacing)
            return jnp.concatenate(
                [targets, y, jnp.stack([n, h]).astype(jnp.float64)])

        _kde_flat_jit = _kde_flat
    return _kde_flat_jit


def compute_kde_wins(win_by_chr, step: int, ind_idx=None,
                     log=None) -> "KDEResult | None":
    """Device-resident computeKDE over DeviceWin/LazyWin window matrices:
    thinning (convertWinData2DoubleData step, src/garlic-data.cpp:2037),
    individual subsetting, bandwidth, and the transform all run on
    device; one ~8 KB fetch returns the 512-point density.  Returns None
    when any chromosome's windows are host arrays or the pooled sample
    count is 0 — callers fall back to win_to_samples + compute_kde."""
    import jax
    import jax.numpy as jnp

    from .device_win import is_device_win, is_lazy_win

    parts = []
    for w in win_by_chr:
        if is_lazy_win(w):
            w = w.make()
        if not is_device_win(w):
            return None
        x = w.win
        if ind_idx is not None:
            x = x[jnp.asarray(np.asarray(ind_idx, dtype=np.int32))]
        else:
            x = x[:w.nind]
        parts.append(x[:, ::step].reshape(-1))
    if not parts:
        return None
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    N = flat.shape[0]
    block = 1 << 18
    # pad to the next power of two, not just the next block multiple:
    # the thinned sample count varies with every winsize candidate, and
    # an exact-N shape recompiles this (sort-heavy, ~20 s) program per
    # candidate of a winsize search.  MISSING pads are masked out of the
    # statistics and contribute exactly 0 to the transform, so only the
    # sort pays the <=2x padding.
    import math
    total = 1 << math.ceil(math.log2(max(N, block)))
    if total > N:
        flat = jnp.concatenate(
            [flat, jnp.full(total - N, jnp.float32(MISSING))])
    with jax.enable_x64(True):
        out = np.asarray(_kde_flat_factory()(flat, block))
    n = int(out[1024])
    if n == 0:
        return None  # host path reproduces the reference failure mode
    if log is not None:
        log.log("KDE with", n, nl=False)
        log.log(" points.")
    return KDEResult(x=out[:512].copy(), y=out[512:1024].copy())


_gauss_wins_jit = None


def _gauss_wins_factory():
    """Blocked f32 Gauss transform over a device-resident thinned sample
    pool at CALLER-PROVIDED targets: the y half of compute_kde_hybrid
    (grid scalars come from the host's exact samples).  Same f32 block
    scheme + f64 accumulation as _kde_flat's transform stage."""
    global _gauss_wins_jit
    if _gauss_wins_jit is None:
        from functools import partial

        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("block",))
        def _gw(flat, tgtf, inv_h2, block: int):
            valid = (flat != jnp.float32(MISSING)) & ~jnp.isnan(flat)
            src = jnp.where(valid, flat, jnp.float32(1e30))
            src = src.reshape(-1, block)

            def body(acc, blk):
                d = blk[:, None] - tgtf[None, :]
                return acc + jnp.sum(jnp.exp(-(d * d) * inv_h2),
                                     axis=0).astype(jnp.float64), None

            y, _ = jax.lax.scan(
                body, jnp.zeros(tgtf.shape[0], jnp.float64), src)
            return y

        _gauss_wins_jit = _gw
    return _gauss_wins_jit



def _kde_grid(data: np.ndarray):
    """Bandwidth + 512-point target grid from the pooled samples —
    shared by compute_kde and compute_kde_hybrid so the .kde x column
    (a compared artifact, byte-identical to the oracle's) cannot drift
    between the two paths.  Exact computeKDE operation order
    (src/garlic-kde.cpp:24-43)."""
    CUT = 3.0
    M = 512
    h = nrd0(data)
    mn = float(np.min(data))
    mx = float(np.max(data))
    mx += CUT * h
    mn -= CUT * h
    i = np.arange(1, M + 1, dtype=np.float64)
    targets = (i / M) * (mx - mn) + mn
    spacing = targets[1] - targets[0]
    import os as _os
    if _os.environ.get("GT_KDE_DEBUG"):
        import sys as _sys
        print(f"[gt_kde] n={data.shape[0]} h={h.hex()} mn={mn.hex()} "
              f"mx={mx.hex()}", file=_sys.stderr)
    return h, targets, spacing


def compute_kde_hybrid(samples: np.ndarray, win_by_chr, step: int,
                       ind_idx=None, log=None,
                       grid=None) -> "KDEResult | None":
    """computeKDE with the round-4 exactness/bandwidth split: bandwidth,
    grid, and n come from the ORACLE-EXACT f64 host samples (the .kde x
    column stays byte-identical to the oracle), while the y transform
    sums over the DEVICE-RESIDENT thinned f32 windows — the ~tens-of-MB
    exact-sample upload never happens.  The f32 window values differ from the
    exact samples by the Phase-I f32 error (~1e-6 relative), perturbing
    y ~1e-6 relative — orders inside the oracle's own FIGTree
    eps=1e-2 approximation AND its time-seeded run-to-run randomness
    (BASELINE.md round 4).  Streaming LazyWin chromosomes are
    rematerialized one at a time (only the thinned pool is kept, with a
    free-before-next-materialize barrier); only HOST-resident window
    rows make this return None — callers fall back to the exact-sample
    transform."""
    import math

    import jax
    import jax.numpy as jnp

    from .device_win import is_device_win, is_lazy_win

    if grid is not None:
        # warm pool-cache hit: (h, targets, spacing, n) replayed from the
        # stored scalars — the 100+ MB host pool never loads (samples may
        # be None)
        h, targets, spacing, n = grid
    else:
        data = np.asarray(samples, dtype=np.float64)
        n = data.shape[0]
    if n == 0:
        return None
    parts = []
    for w in win_by_chr:
        lazy = is_lazy_win(w)
        if lazy:
            # streaming: rematerialize ONE chromosome's windows, keep
            # only the thinned pool (a strided slice copies into a new
            # ~1/step-size buffer; the full matrix frees before the next
            # chromosome materializes)
            w = w.make()
        if not is_device_win(w):
            return None  # host rows: no resident pool to reuse
        x = w.win
        if ind_idx is not None:
            x = x[jnp.asarray(np.asarray(ind_idx, dtype=np.int32))]
        else:
            x = x[:w.nind]
        part = x[:, ::step].reshape(-1)
        if lazy:
            # the big rematerialized matrix must free before the next
            # chromosome's materializes; resident windows never block
            # (a sync per chromosome would serialize host and device)
            part.block_until_ready()
        parts.append(part)
    if not parts:
        return None
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    if log is not None:
        log.log("KDE with", n, nl=False)
        log.log(" points.")
    if grid is None:
        h, targets, spacing = _kde_grid(data)
    block = 1 << 18
    N = int(flat.shape[0])
    total = 1 << math.ceil(math.log2(max(N, block)))
    if total > N:
        flat = jnp.concatenate(
            [flat, jnp.full(total - N, jnp.float32(MISSING))])
    with jax.enable_x64(True):
        y = np.asarray(_gauss_wins_factory()(
            flat, jnp.asarray(targets.astype(np.float32)),
            jnp.float32(1.0 / (h * h)), block), dtype=np.float64)
    y = y / float(n)
    s = float(np.sum(y))
    y = y / (s * spacing)
    return KDEResult(x=targets, y=y)


def compute_kde(data: np.ndarray, log=None, device: bool = False,
                mesh=None, grid=None) -> KDEResult:
    """Full computeKDE (src/garlic-kde.cpp:14-103).

    mesh: a ("dp", "sp") jax mesh — the transform (the O(N x 512) part)
    runs as per-shard partials psum'd over every device
    (parallel.engine.gauss_transform_sharded); bandwidth/grid scalars are
    computed host-side from the (already thinned) pooled samples, exactly
    like the single-device path, so the same samples give the same grid.

    grid: optional (h, targets, spacing, n) — precomputed scalars (pool
    cache); skips the sort/nrd0 pass, the transform still consumes
    `data` in pooling order so y is byte-identical either way."""
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    if log is not None:
        log.log("KDE with", n, nl=False)
        log.log(" points.")
    if grid is not None:
        h, targets, spacing, _ = grid
    else:
        h, targets, spacing = _kde_grid(data)
    if mesh is not None:
        from ..parallel.engine import gauss_transform_sharded
        y = gauss_transform_sharded(data, targets, h, mesh) / float(n)
    else:
        y = gauss_transform(data, targets, h, device=device)
    s = float(np.sum(y))
    y = y / (s * spacing)
    return KDEResult(x=targets, y=y)
