"""Multi-chip SPMD ROH engine: shard_map kernels + collectives.

This is the scale-out path the reference never had (its parallelism stops at
pthreads over locus ranges within one process, src/garlic-roh.cpp:184-194).
Each phase of the pipeline has a production SPMD program over the
("dp", "sp") mesh (see parallel/mesh.py), all driven from pipeline.py on
--tpu-mesh runs and from the multi-host loader:

* LOD window scan (Phase I),  lod_windows_sharded: genotypes [I, L] sharded
  (dp, sp), per-locus terms elementwise, a (winsize-1) locus halo pulled
  from the right sp neighbor via ppermute, then VALID window sums by exact
  shifted-add doubling;
* allele frequencies, allele_freq_sharded: psum of per-shard
  numerators/denominators over dp (multi-host loading);
* KDE (Phase II), gauss_transform_sharded: per-shard partial Gauss
  transform at the fixed 512-target grid, psum over (dp, sp);
* GMM (Phase IV), fit_gmm_sharded: full EM loop on device, psum of the
  sufficient statistics (Σr, Σr·x, Σr·x²) per iteration.

Everything is static-shaped and trace-once; the only cross-device traffic is
the W-1 halo (ICI neighbor exchange) and the O(512)/O(K) reductions.
"""

from __future__ import annotations


from typing import Tuple

import numpy as np

from ..core.types import MISSING
from .mesh import AXIS_DP, AXIS_SP

KDE_GRID_POINTS = 512  # reference KDE target count (src/garlic-kde.cpp:33)


# ---------------------------------------------------------------------------
# Block-local pieces (run inside shard_map; jnp only)
# ---------------------------------------------------------------------------

def _freq_block(geno_blk):
    """Per-locus '1'-allele numerator/denominator on the local block.

    Mirrors the on-the-fly freq accumulation of loadTPEDData
    (src/garlic-data.cpp:109-160): each diploid genotype g in {0,1,2}
    contributes g copies of the '1' allele over 2 chromosomes; missing (-9)
    contributes nothing."""
    import jax.numpy as jnp
    valid = geno_blk >= 0
    num = jnp.sum(jnp.where(valid, geno_blk, 0).astype(jnp.float32), axis=0)
    den = 2.0 * jnp.sum(valid.astype(jnp.float32), axis=0)
    return num, den


def _lod_terms_block(geno_blk, freq_blk, error):
    """Elementwise lod(g, p, e) (src/garlic-roh.cpp:355-386) in f32.

    Branch-free: three per-locus table rows + VPU selects, no gathers.
    `error` is a python float (scalar genotyping error) or an [I_s, L_s]
    block (TGLS per-genotype error, src/garlic-roh.cpp:68,91-95)."""
    import jax.numpy as jnp
    p = freq_blk
    e = jnp.asarray(error, jnp.float32)
    one_minus = 1.0 - p
    non0 = one_minus * one_minus
    aut0 = (1.0 - e) * one_minus + e * non0
    non1 = 2.0 * p * one_minus
    aut1 = e * non1
    non2 = p * p
    aut2 = (1.0 - e) * p + e * non2
    r0 = jnp.log10(aut0 / non0)
    r1 = jnp.log10(aut1 / non1)
    r2 = jnp.log10(aut2 / non2)
    if r0.ndim == 1:  # scalar error: per-locus rows broadcast over inds
        r0, r1, r2 = r0[None, :], r1[None, :], r2[None, :]
    g = geno_blk.astype(jnp.int32)
    a = jnp.where(g == 0, r0,
                  jnp.where(g == 1, r1,
                            jnp.where(g == 2, r2, 0.0)))
    mono = (p <= 0.0) | (p >= 1.0)
    return jnp.where(mono[None, :], 0.0, a).astype(jnp.float32)


def _window_sums(a, winsize: int):
    """VALID sliding-window sums along the last axis ([I, N] -> [I, N-W+1])
    via exact shifted-add doubling (true f32 adds — no convolution whose
    lowering may accumulate in reduced precision near the cutoff)."""
    from ..ops.lod import window_sums_exact
    return window_sums_exact(a, winsize)


def check_halo_fits(L_padded: int, width: int, n_sp: int) -> None:
    """The ppermute halo pulls `width` columns from ONE right neighbor, so
    each sp shard must hold at least that many loci — otherwise x_blk[:, :w]
    silently clamps and the windows straddling two shards go wrong (or the
    trace dies with an opaque shape error).  Raise a clear error instead."""
    per_shard = L_padded // n_sp
    if width > per_shard:
        raise ValueError(
            f"ERROR: winsize-1 = {width} exceeds the per-shard locus width "
            f"{per_shard} ({L_padded} loci over sp={n_sp}); reduce the sp "
            "axis of --tpu-mesh or the window size.")


def _halo_right(x_blk, width: int, axis_name: str):
    """Pull the leading `width` columns of the right (sp_id+1) neighbor.

    Ring permutation: the last shard receives shard 0's columns — those
    wrapped windows are invalid by construction and must be masked by the
    caller (the global window-missing mask is True past nwin = L - W + 1)."""
    from jax import lax
    n = lax.axis_size(axis_name)
    if n == 1:
        import jax.numpy as jnp
        return jnp.zeros_like(x_blk[:, :width])
    head = x_blk[:, :width]
    # send my head to my LEFT neighbor == receive right neighbor's head
    perm = [(i, (i - 1) % n) for i in range(n)]
    return lax.ppermute(head, axis_name, perm)


# ---------------------------------------------------------------------------
# Production SPMD collectives (called from pipeline.py on --tpu-mesh runs
# and from multi-host loading; the dryrun drives the same functions)
# ---------------------------------------------------------------------------

_freq_mesh_cache = {}


def allele_freq_sharded(geno, mesh):
    """Allele frequencies of a (dp, sp)-sharded genotype block: per-shard
    '1'-allele numerators/denominators psum'd over dp (the collective
    replacement for loadTPEDData's on-the-fly accumulation,
    src/garlic-data.cpp:109-160).  Used when each host only holds its own
    individual shard (multi-host loading) and by the dryrun.

    geno: [I, L] int8 (host array or device array); returns [L] f64."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = id(mesh)
    fn = _freq_mesh_cache.get(key)
    if fn is None:
        import jax.numpy as jnp
        from jax import lax

        def block(geno_blk):
            # numerator/denominator reduce over individuals (dp) only; the
            # sp axis shards loci, so no reduction there
            num, den = _freq_block(geno_blk)
            num = lax.psum(num, AXIS_DP)
            den = lax.psum(den, AXIS_DP)
            return jnp.where(den > 0, num / den, 0.0)

        sh = jax.shard_map(block, mesh=mesh,
                           in_specs=(P(AXIS_DP, AXIS_SP),),
                           out_specs=P(AXIS_SP))
        fn = jax.jit(sh)
        _freq_mesh_cache[key] = fn
    from .multihost import put_dp_sharded, to_host
    gs = NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    return to_host(fn(put_dp_sharded(geno, mesh, gs))).astype(np.float64)


_freq_counts_cache = {}


def allele_freq_counts_sharded(num, den, mesh):
    """Global allele frequencies from PER-HOST partial count planes: the
    production freq collective on multi-process column-range loads.

    Each cooperating process passes the [L] '1'-allele numerator /
    observed-allele denominator over ITS stored individual columns
    (integer-valued f64 straight from the range parser, so the psum
    reproduces loadTPEDData's full-panel counts exactly,
    src/garlic-data.cpp:109-160); the division then matches the
    reference's nalleles/total bit-for-bit.  The planes ride the dp axis:
    host h contributes its plane on its first owned dp row (zeros on the
    rest), one psum over dp merges them, and every host reads back the
    identical [L] f64 freq.

    Requires the row-aligned device layout put_dp_sharded checks
    (local_device_count % n_sp == 0).  Falls back to a deterministic
    host-side allgather+sum when the backend cannot run f64 programs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    L = num.shape[0]
    n_dp = mesh.shape[AXIS_DP]
    n_sp = mesh.shape[AXIS_SP]
    p = jax.process_count()
    L2 = -(-max(L, 1) // n_sp) * n_sp
    rows = n_dp // p if p > 1 else n_dp
    local = np.zeros((rows, 2, L2), dtype=np.float64)
    local[0, 0, :L] = num
    local[0, 1, :L] = den

    key = (id(mesh), L2)
    fn = _freq_counts_cache.get(key)
    if fn is None:
        import jax.numpy as jnp
        from jax import lax

        def block(x):
            s = lax.psum(x, AXIS_DP)            # [rows_blk, 2, L_s]
            num_g = jnp.sum(s[:, 0, :], axis=0)  # rows_blk == n_dp/n_dp = 1
            den_g = jnp.sum(s[:, 1, :], axis=0)
            return jnp.where(den_g > 0, num_g / den_g, 0.0)

        sh = jax.shard_map(block, mesh=mesh,
                           in_specs=(P(AXIS_DP, None, AXIS_SP),),
                           out_specs=P(AXIS_SP))
        fn = jax.jit(sh)
        _freq_counts_cache[key] = fn

    from .multihost import to_host
    gs = NamedSharding(mesh, P(AXIS_DP, None, AXIS_SP))
    with jax.enable_x64(True):
        if p == 1:
            glob = jax.device_put(local, gs)
        else:
            glob = jax.make_array_from_process_local_data(gs, local)
        out = to_host(fn(glob))
    return np.asarray(out, dtype=np.float64)[:L]


_gauss_mesh_cache = {}


def gauss_transform_sharded(sources, targets, h, mesh) -> np.ndarray:
    """Distributed exact Gauss transform: sum_j exp(-(x_j - t)^2 / h^2) at
    each of the 512 targets, as per-shard partial transforms psum'd over
    the whole mesh.  This is the production Phase-II collective (the
    FIGTree replacement, src/garlic-kde.cpp:14-103): sources shard over
    every device, only the [512] partial densities ride the interconnect.

    Returns the raw transform (no 1/n weighting) as [M] float64."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = int(np.asarray(sources).shape[0])
    m = int(np.asarray(targets).shape[0])
    if n == 0:
        return np.zeros(m, dtype=np.float64)
    ndev = int(mesh.devices.size)
    per = -(-n // ndev)
    per = 1 << max(per - 1, 1).bit_length()  # pow2 bucket: bounded compiles
    n2 = per * ndev
    # sentinel sources square to inf in f32 -> exp(-inf) = 0: no effect
    src = np.full(n2, 1e30, dtype=np.float32)
    src[:n] = np.asarray(sources, dtype=np.float32)

    key = (id(mesh), per, m)
    fn = _gauss_mesh_cache.get(key)
    if fn is None:
        chunk = min(per, 1 << 13)

        def block(src_blk, tgt, inv_h2):
            xs = src_blk.reshape(-1, chunk)

            def body(acc, row):
                d = row[:, None] - tgt[None, :]
                return acc + jnp.sum(jnp.exp(-(d * d) * inv_h2), axis=0), None

            # the scan carry is device-varying (each shard accumulates its
            # own partial), so mark the init accordingly
            acc0 = lax.pcast(jnp.zeros(tgt.shape[0], jnp.float32),
                             (AXIS_DP, AXIS_SP), to="varying")
            acc, _ = lax.scan(body, acc0, xs)
            return lax.psum(lax.psum(acc, AXIS_DP), AXIS_SP)

        sh = jax.shard_map(block, mesh=mesh,
                           in_specs=(P((AXIS_DP, AXIS_SP)), P(), P()),
                           out_specs=P())
        fn = jax.jit(sh)
        _gauss_mesh_cache[key] = fn
    ss = NamedSharding(mesh, P((AXIS_DP, AXIS_SP)))
    out = fn(jax.device_put(src, ss),
             jnp.asarray(np.asarray(targets, dtype=np.float32)),
             jnp.float32(1.0 / (h * h)))
    return np.asarray(out, dtype=np.float64)


_gmm_mesh_cache = {}


def fit_gmm_sharded(x, k: int, w0, mu0, var0, mesh, max_iter: int = 1000,
                    precision: float = 1e-5, verbose: bool = False):
    """Phase-IV GMM-EM with psum'd sufficient statistics over the mesh.

    The production path for --tpu-mesh auto-bounds runs: ROH lengths shard
    over every device, each EM iteration is one fused E+M pass whose
    sufficient statistics (sum_r, sum_r*x, sum_r*x^2) and loglikelihood
    psum over the mesh inside a lax.while_loop (matching GMM::estimate's
    iteration/convergence structure, src/gmm.cpp:276-443).

    Runs in float64 (the |delta loglik| <= 1e-5 convergence test is
    unrepresentable in f32 at WGS sample counts).
    Returns ops.gmm.GMMResult, matching fit_gmm's semantics bit-for-bit up
    to psum reduction order."""
    from ..ops.gmm import GMMResult

    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    ndev = int(mesh.devices.size)
    per = -(-n // ndev)
    n2 = per * ndev
    xp = np.zeros(n2, dtype=np.float64)
    xp[:n] = x
    wp = np.zeros(n2, dtype=np.float64)
    wp[:n] = 1.0

    key = (id(mesh), k)
    fn = _gmm_mesh_cache.get(key)
    if fn is None:
        def block(x_blk, wt_blk, w, mu, var, itmax, prec):
            nn = lax.psum(lax.psum(jnp.sum(wt_blk), AXIS_DP), AXIS_SP)

            def stats(params):
                w, mu, var = params
                # GMM::update's math (src/gmm.cpp:276-331): log resp with
                # logsumexp, the extra (==1) normalization, moment sums
                lw = jnp.log(w)[None, :]
                lv = jnp.log(var)[None, :]
                d = x_blk[:, None] - mu[None, :]
                logp = lw + (-0.5 * jnp.log(2.0 * jnp.pi) - 0.5 * lv
                             - (d * d) / (2.0 * var[None, :]))
                lmax = jnp.max(logp, axis=1, keepdims=True)
                tmp = lmax[:, 0] + jnp.log(
                    jnp.sum(jnp.exp(logp - lmax), axis=1))
                ll_loc = jnp.sum(tmp * wt_blk)
                resp = jnp.exp(logp - tmp[:, None])
                den = jnp.sum(resp, axis=1, keepdims=True)
                r = resp / den * wt_blk[:, None]
                s0 = jnp.sum(r, axis=0)
                s1 = jnp.sum(r * x_blk[:, None], axis=0)
                s2 = jnp.sum(r * (x_blk * x_blk)[:, None], axis=0)
                s0 = lax.psum(lax.psum(s0, AXIS_DP), AXIS_SP)
                s1 = lax.psum(lax.psum(s1, AXIS_DP), AXIS_SP)
                s2 = lax.psum(lax.psum(s2, AXIS_DP), AXIS_SP)
                ll = lax.psum(lax.psum(ll_loc, AXIS_DP), AXIS_SP)
                return s0, s1, s2, ll

            big = jnp.finfo(jnp.float64).max

            def cond(st):
                w, mu, var, last_ll, ll, it, done = st
                return (~done) & (it < itmax)

            def body(st):
                w, mu, var, last_ll, ll_prev, it, done = st
                s0, s1, s2, ll = stats((w, mu, var))
                w2 = s0 / nn
                mu2 = s1 / s0
                var2 = s2 / s0 - mu2 * mu2
                bad = ~(jnp.all(jnp.isfinite(mu2)) &
                        jnp.all(jnp.isfinite(var2)))
                conv = jnp.abs(ll - last_ll) <= prec
                # on a bad update keep going out of the loop; host raises
                done = conv | bad
                return (w2, mu2, var2,
                        jnp.where(conv | bad, last_ll, ll), ll,
                        it + 1, done)

            st0 = (w, mu, var, -big, -big, jnp.int32(0),
                   jnp.array(False))
            w, mu, var, last_ll, ll, it, done = lax.while_loop(
                cond, body, st0)
            return w, mu, var, ll, it, done

        sh = jax.shard_map(
            block, mesh=mesh,
            in_specs=(P((AXIS_DP, AXIS_SP)), P((AXIS_DP, AXIS_SP)),
                      P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(), P(), P()))
        fn = jax.jit(sh)
        _gmm_mesh_cache[key] = fn

    if verbose:
        import sys
        print(f"Begin GMM estimation with k = {k} Gaussians...",
              file=sys.stderr)
    ss = NamedSharding(mesh, P((AXIS_DP, AXIS_SP)))
    with jax.enable_x64(True):
        w, mu, var, ll, it, done = fn(
            jax.device_put(xp, ss), jax.device_put(wp, ss),
            jnp.asarray(w0, dtype=jnp.float64),
            jnp.asarray(mu0, dtype=jnp.float64),
            jnp.asarray(var0, dtype=jnp.float64),
            jnp.int32(max_iter), jnp.float64(precision))
        w = np.asarray(w, dtype=np.float64)
        mu = np.asarray(mu, dtype=np.float64)
        var = np.asarray(var, dtype=np.float64)
        ll = float(ll)
        it = int(it)
        done = bool(done)
    if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(var))):
        raise FloatingPointError(
            "GMM component collapsed (non-finite parameters)")
    bic = -2.0 * ll + (3.0 * k - 1) * np.log(n)
    return GMMResult(weights=w, means=mu, variances=var, loglikelihood=ll,
                     bic=float(bic), converged=done, iterations=it)


_sharded_cache = {}


def lod_windows_sharded(chrom, centro, winsize: int, error: float,
                        max_gap: int, mesh, use_gl: bool = False):
    """Phase-I window scan sharded over a ("dp", "sp") mesh -> DeviceWin.

    Individuals shard over dp, loci over sp with a (winsize-1) ppermute
    halo; the per-SNP frequency row is replicated along dp and sharded
    along sp.  use_gl shards the TGLS per-genotype error matrix exactly
    like the genotypes (src/garlic-roh.cpp:68,91-95).  The result stays
    device-resident (and sharded) so the downstream covered/thinned
    kernels compile as SPMD programs over the same mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.device_win import DeviceWin

    local_mode = chrom.nind_total is not None  # per-host column-range load
    I = chrom.nind_global
    L = chrom.nloci
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    miss = full_window_missing(chrom.positions, winsize, max_gap,
                               cstart, cend)
    if local_mode:
        geno_p, miss_p = pad_local_for_mesh(chrom.genotypes, miss, mesh, I)
        L2 = geno_p.shape[1]
    else:
        geno_p, miss_p, _ = pad_for_mesh(chrom.genotypes, miss, mesh)
        L2 = geno_p.shape[1]
    check_halo_fits(L2, winsize - 1, mesh.shape[AXIS_SP])
    freq_p = np.zeros(L2, dtype=np.float32)
    freq_p[:L] = np.asarray(chrom.freq, dtype=np.float32)

    fn = make_sharded_lod_fn(mesh, winsize, error, use_gl=use_gl)
    gs = NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    ls = NamedSharding(mesh, P(AXIS_SP))
    from .multihost import put_dp_sharded
    if use_gl:
        gl_p = np.full(geno_p.shape, float(error), dtype=np.float32)
        gl_loc = np.asarray(chrom.gl, dtype=np.float32)
        gl_p[:gl_loc.shape[0], :L] = gl_loc
        win = fn(put_dp_sharded(geno_p, mesh, gs, local_block=local_mode),
                 put_dp_sharded(gl_p, mesh, gs, local_block=local_mode),
                 jax.device_put(freq_p, ls), jax.device_put(miss_p, ls))
    else:
        win = fn(put_dp_sharded(geno_p, mesh, gs, local_block=local_mode),
                 jax.device_put(freq_p, ls), jax.device_put(miss_p, ls))
    return DeviceWin(win=win, nind=I, nloci=L)


def make_sharded_lod_fn(mesh, winsize: int, error: float,
                        use_gl: bool = False):
    """Jitted SPMD window-scan step over `mesh` (cached per config):
    (geno P(dp,sp), [gl P(dp,sp)], freq P(sp), win_missing P(sp))
    -> win P(dp,sp)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    key = (id(mesh), winsize, float(error), use_gl)
    fn = _sharded_cache.get(key)
    if fn is None:
        def scan_block(a, miss_blk):
            halo = _halo_right(a, winsize - 1, AXIS_SP)
            a_ext = jnp.concatenate([a, halo], axis=1)
            s = _window_sums(a_ext, winsize)
            return jnp.where(miss_blk[None, :], jnp.float32(MISSING), s)

        if use_gl:
            def block_fn(geno_blk, gl_blk, freq_blk, miss_blk):
                a = _lod_terms_block(geno_blk, freq_blk, gl_blk)
                return scan_block(a, miss_blk)

            in_specs = (P(AXIS_DP, AXIS_SP), P(AXIS_DP, AXIS_SP),
                        P(AXIS_SP), P(AXIS_SP))
        else:
            def block_fn(geno_blk, freq_blk, miss_blk):
                a = _lod_terms_block(geno_blk, freq_blk, error)
                return scan_block(a, miss_blk)

            in_specs = (P(AXIS_DP, AXIS_SP), P(AXIS_SP), P(AXIS_SP))

        shard_fn = jax.shard_map(block_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=P(AXIS_DP, AXIS_SP))
        fn = jax.jit(shard_fn)
        _sharded_cache[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Sharded weighted path: banded LD + wLOD window scan over the mesh
# ---------------------------------------------------------------------------

_ld_mesh_cache = {}
_wlod_mesh_cache = {}


def _halo_left_rows(x_blk, width: int, axis_name: str):
    """Pull the trailing `width` ROWS of the left (sp_id-1) neighbor.

    Shard 0 receives the last shard's rows (ring) — the caller must zero
    them (global rows < 0 contribute 0 to the band recurrences)."""
    from jax import lax
    n = lax.axis_size(axis_name)
    if n == 1:
        import jax.numpy as jnp
        return jnp.zeros_like(x_blk[-width:])
    tail = x_blk[-width:]
    # send my tail to my RIGHT neighbor == receive left neighbor's tail
    perm = [(i, (i + 1) % n) for i in range(n)]
    return lax.ppermute(tail, axis_name, perm)


def _halo_right_rows(x_blk, width: int, axis_name: str):
    """Pull the leading `width` ROWS of the right (sp_id+1) neighbor
    (row-axis analog of _halo_right; ring wrap on the last shard feeds
    only masked windows)."""
    from jax import lax
    n = lax.axis_size(axis_name)
    if n == 1:
        import jax.numpy as jnp
        return jnp.zeros_like(x_blk[:width])
    head = x_blk[:width]
    perm = [(i, (i - 1) % n) for i in range(n)]
    return lax.ppermute(head, axis_name, perm)


def ld_band_sharded(chrom, winsize: int, phased: bool, sub_idx, mesh):
    """[L2, W] LD band sharded P(sp) over rows — the collective version of
    ops/device_wlod.ld_band_device (reference calcLDData,
    src/garlic-data.cpp:330-646).

    Pair counts reduce over the (sub)panel individuals with a psum over
    dp; each locus pairs with up to W-1 right neighbors, so the pair
    stage pulls a (W-1)-column halo of the genotype indicators, and the
    band assembly pulls a (W-1)-row halo of the pair band from the left
    neighbor (zeroed on shard 0, matching the P[m-d]=0, m-d<0 boundary).
    Returns a device array still sharded for wlod_windows_sharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.ld import geno_hom_freq

    local_mode = chrom.nind_total is not None  # per-host column-range load
    if local_mode:
        # this host's row block only; the LD subsample keeps the global
        # layout and MASKS non-selected owned rows to missing (-9): pair
        # counts then reduce over exactly the subsample, identically to
        # the materialized-subset path, without a cross-host row shuffle
        g = np.asarray(chrom.genotypes)
        if sub_idx is not None:
            rr = np.asarray(sub_idx, dtype=np.int64)
            own = rr[(rr >= chrom.row0) & (rr < chrom.row0 + chrom.nind)] \
                - chrom.row0
            keep = np.zeros(g.shape[0], dtype=bool)
            keep[own] = True
            g = np.where(keep[:, None], g, np.int8(-9))
        I = chrom.nind_global if sub_idx is None else int(len(sub_idx))
        L = chrom.nloci
        miss_dummy = np.ones(L, dtype=bool)
        gp, _ = pad_local_for_mesh(g, miss_dummy, mesh,
                                   chrom.nind_global)
        L2 = gp.shape[1]
    else:
        g = chrom.genotypes if sub_idx is None else chrom.genotypes[sub_idx]
        I, L = g.shape
        gp, _, _ = pad_for_mesh(g, np.ones(L, dtype=bool), mesh)
        L2 = gp.shape[1]
    n_sp = mesh.shape[AXIS_SP]
    check_halo_fits(L2, winsize - 1, n_sp)

    if phased:
        if local_mode:
            # local rows as-is: the subsample reduces to the g mask
            # above (masked rows contribute no pairs), so fc stays the
            # full local block — sub_idx holds GLOBAL indices that must
            # not index the local rows
            fc = chrom.first_copy
        else:
            fc = chrom.first_copy if sub_idx is None \
                else chrom.first_copy[sub_idx]
        fcp = np.zeros(gp.shape, dtype=np.int8)
        fcp[:np.asarray(fc).shape[0], :L] = np.asarray(fc, dtype=np.int8)
        marg = np.zeros(L2, dtype=np.float32)
        marg[:L] = np.asarray(chrom.freq, dtype=np.float32)
    else:
        fcp = np.zeros(gp.shape, dtype=np.int8)  # unused placeholder
        marg = np.zeros(L2, dtype=np.float32)
        # full-panel marginal homozygosity freqs (src/garlic-data.cpp:648)
        if local_mode:
            from ..ops.ld import geno_hom_counts, geno_hom_freq_from_counts
            from jax.experimental import multihost_utils
            hom, tot = geno_hom_counts(chrom.genotypes)
            # x64 REQUIRED: allgather silently downcasts int64 without it
            with jax.enable_x64(True):
                planes = np.asarray(multihost_utils.process_allgather(
                    np.stack([hom, tot])[None], tiled=True))
            marg[:L] = np.nan_to_num(geno_hom_freq_from_counts(
                planes[:, 0].sum(axis=0), planes[:, 1].sum(axis=0)))
        else:
            marg[:L] = np.nan_to_num(geno_hom_freq(chrom.genotypes))

    key = (id(mesh), winsize, phased)
    fn = _ld_mesh_cache.get(key)
    if fn is None:
        W = winsize

        def block(geno_blk, fc_blk, marg_blk):
            from jax import lax
            I_s, L_s = geno_blk.shape
            valid = (geno_blk != -9)
            vf = valid.astype(jnp.float32)
            marg_ext = jnp.concatenate(
                [marg_blk, _halo_right(marg_blk[None, :], W - 1,
                                       AXIS_SP)[0]])
            if phased:
                # phased r^2 from 2-locus haplotype freq x11
                # (src/garlic-data.cpp:585-617)
                g2 = (geno_blk == 2)
                g1 = (geno_blk == 1)
                b2 = jnp.concatenate(
                    [g2, _halo_right(g2, W - 1, AXIS_SP)], axis=1)
                b1 = jnp.concatenate(
                    [g1, _halo_right(g1, W - 1, AXIS_SP)], axis=1)
                bfc = jnp.concatenate(
                    [fc_blk, _halo_right(fc_blk, W - 1, AXIS_SP)], axis=1)
                bv = jnp.concatenate(
                    [valid, _halo_right(valid, W - 1, AXIS_SP)], axis=1)
                nums, dens = [], []
                for d in range(1, W):
                    pv = valid & bv[:, d:d + L_s]
                    x11 = (2 * (g2 & b2[:, d:d + L_s])
                           + (g1 & b2[:, d:d + L_s])
                           + (g2 & b1[:, d:d + L_s])
                           + (g1 & b1[:, d:d + L_s]
                              & (fc_blk == bfc[:, d:d + L_s])))
                    nums.append(jnp.sum(
                        jnp.where(pv, x11.astype(jnp.float32), 0.0), axis=0))
                    dens.append(2.0 * jnp.sum(pv.astype(jnp.float32), axis=0))
            else:
                # HR^2: joint hom-hom counts (src/garlic-data.cpp:558-583)
                homv = valid & (geno_blk != 1)
                hf = homv.astype(jnp.float32)
                bvf = jnp.concatenate(
                    [vf, _halo_right(vf, W - 1, AXIS_SP)], axis=1)
                bhf = jnp.concatenate(
                    [hf, _halo_right(hf, W - 1, AXIS_SP)], axis=1)
                nums, dens = [], []
                for d in range(1, W):
                    nums.append(jnp.sum(hf * bhf[:, d:d + L_s], axis=0))
                    dens.append(jnp.sum(vf * bvf[:, d:d + L_s], axis=0))
            stats = jnp.stack(nums + dens, axis=0)       # [2(W-1), L_s]
            stats = lax.psum(stats, AXIS_DP)
            num = stats[:W - 1]
            den = stats[W - 1:]
            MA = marg_ext[:L_s]
            ok = (MA > 0) & (MA < 1)
            denom = MA * (1.0 - MA)
            cols = [jnp.zeros((L_s,), jnp.float32)]      # d = 0 slot unused
            for d in range(1, W):
                MB = marg_ext[d:d + L_s]
                okB = (MB > 0) & (MB < 1)
                mean = num[d - 1] / den[d - 1]
                cov = mean - MA * MB
                r2 = (cov * cov) / (denom * MB * (1.0 - MB))
                r2 = jnp.minimum(r2, 1.0)
                r2 = jnp.where(ok & okB, r2, 0.0)
                r2 = jnp.where(jnp.isfinite(r2), r2, 0.0)
                cols.append(r2)
            Pb = jnp.stack(cols, axis=1)                 # [L_s, W]

            # ---- band assembly with a (W-1)-row left halo ----
            halo = _halo_left_rows(Pb, W - 1, AXIS_SP)
            sp_id = lax.axis_index(AXIS_SP)
            halo = jnp.where(sp_id == 0, 0.0, halo)      # global m < 0 -> 0
            Pe = jnp.concatenate([halo, Pb], axis=0)     # [L_s + W - 1, W]
            S = jnp.cumsum(Pe, axis=1)                   # S[r, j] = sum_{d<=j}
            Le = Pe.shape[0]
            prev = jnp.zeros((Le,), Pe.dtype)
            outs = [prev]
            for j in range(1, W):
                shifted = jnp.concatenate(
                    [jnp.zeros((j,), Pe.dtype), Pe[:-j, j]])
                prev = prev + shifted
                outs.append(prev)
            D = jnp.stack(outs, axis=1)                  # [Le, W]
            # LD[l, j] = 1 + D[l+j, j] + S[l+j, W-1-j] (the cumsum
            # decomposition, ops/ld.py assemble_ld_fast).  Local block
            # rows are ext rows [W-1, Le); rows l+j >= L_s live on the
            # RIGHT neighbor — pull its first W-1 BLOCK rows of (S, D)
            # (correct there because its own left halo is this shard's
            # tail).  On the last shard the ring wraps: those rows feed
            # only windows past nwin, which are masked MISSING.
            S_blk = S[W - 1:]                            # [L_s, W]
            D_blk = D[W - 1:]
            Sr = _halo_right_rows(S_blk, W - 1, AXIS_SP)
            Dr = _halo_right_rows(D_blk, W - 1, AXIS_SP)
            S_all = jnp.concatenate([S_blk, Sr], axis=0)
            D_all = jnp.concatenate([D_blk, Dr], axis=0)
            cols = []
            for j in range(W):
                cols.append(1.0 + D_all[j:j + L_s, j]
                            + S_all[j:j + L_s, W - 1 - j])
            return jnp.stack(cols, axis=1)               # [L_s, W]

        shard_fn = jax.shard_map(
            block, mesh=mesh,
            in_specs=(P(AXIS_DP, AXIS_SP), P(AXIS_DP, AXIS_SP), P(AXIS_SP)),
            out_specs=P(AXIS_SP, None))
        fn = jax.jit(shard_fn)
        _ld_mesh_cache[key] = fn

    gs = NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    ls = NamedSharding(mesh, P(AXIS_SP))
    from .multihost import put_dp_sharded
    return fn(put_dp_sharded(gp, mesh, gs, local_block=local_mode),
              put_dp_sharded(fcp, mesh, gs, local_block=local_mode),
              jax.device_put(marg, ls))


def wlod_windows_sharded(chrom, centro, ld_dev, winsize: int, error,
                        max_gap: int, use_gl: bool, mu: float, M: int,
                        mesh):
    """Weighted Phase-I over the mesh -> DeviceWin (collective version of
    ops/device_wlod.wlod_windows_device; reference calcwLOD,
    src/garlic-roh.cpp:144-277).

    Per-locus weighted scores (host f64, identical to the single-device
    path) shard (dp, sp); window l sums score[l+j] * (1/LD[l][j]) with a
    (winsize-1)-column score halo from the right sp neighbor; the LD band
    rows are already sharded P(sp) by ld_band_sharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.device_win import DeviceWin
    from ..ops.lod import window_missing_mask
    from ..ops.wlod import wlod_scores

    local_mode = chrom.nind_total is not None  # per-host column-range load
    I = chrom.nind_global
    L = chrom.nloci
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    nwin = max(L - winsize + 1, 0)
    L2 = int(ld_dev.shape[0])
    n_dp = mesh.shape[AXIS_DP]
    I2 = -(-I // n_dp) * n_dp
    check_halo_fits(L2, winsize - 1, mesh.shape[AXIS_SP])

    # per-locus weighted scores for the rows THIS HOST holds (the whole
    # panel on replicated loads); pad rows contribute 0-score windows,
    # clipped by DeviceWin.nind exactly like the unweighted path
    score = wlod_scores(chrom, error, use_gl, mu, M).astype(np.float32)
    if local_mode:
        sp_arr = np.zeros((I2 // jax.process_count(), L2),
                          dtype=np.float32)
    else:
        sp_arr = np.zeros((I2, L2), dtype=np.float32)
    sp_arr[:score.shape[0], :L] = score
    miss_p = np.ones(L2, dtype=bool)
    if nwin > 0:
        miss_p[:nwin] = window_missing_mask(chrom.positions, winsize,
                                            max_gap, cstart, cend)

    key = (id(mesh), winsize, "wlod")
    fn = _wlod_mesh_cache.get(key)
    if fn is None:
        W = winsize

        def block(score_blk, ld_blk, miss_blk):
            from jax import lax
            I_s, L_s = score_blk.shape
            halo = _halo_right(score_blk, W - 1, AXIS_SP)
            ext = jnp.concatenate([score_blk, halo], axis=1)
            inv = 1.0 / ld_blk                           # [L_s, W]
            acc = jnp.zeros((I_s, L_s), jnp.float32)
            tmax = jnp.float32(0.0)
            for j in range(W):
                # same j-order as the single-device kernel and the
                # reference's inner i-loop (src/garlic-roh.cpp:259-272)
                t = ext[:, j:j + L_s] * inv[:, j][None, :]
                acc = acc + t
                # tie-patrol band scale: max finite |term| (the same
                # data-driven scale the single-device weighted kernel
                # ships — 1/LD can amplify terms arbitrarily), merged
                # over the whole mesh with a pmax
                tmax = jnp.maximum(
                    tmax,
                    jnp.max(jnp.where(jnp.isfinite(t), jnp.abs(t), 0.0)))
            tmax = lax.pmax(lax.pmax(tmax, AXIS_DP), AXIS_SP)
            return (jnp.where(miss_blk[None, :], jnp.float32(MISSING), acc),
                    tmax)

        shard_fn = jax.shard_map(
            block, mesh=mesh,
            in_specs=(P(AXIS_DP, AXIS_SP), P(AXIS_SP, None), P(AXIS_SP)),
            out_specs=(P(AXIS_DP, AXIS_SP), P()))
        fn = jax.jit(shard_fn)
        _wlod_mesh_cache[key] = fn

    gs = NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    ls = NamedSharding(mesh, P(AXIS_SP))
    from .multihost import put_dp_sharded
    win, tsc = fn(put_dp_sharded(sp_arr, mesh, gs, local_block=local_mode),
                  ld_dev, jax.device_put(miss_p, ls))
    return DeviceWin(win=win, nind=I, nloci=L, tie_scale=tsc)


# ---------------------------------------------------------------------------
# Host-side driver helpers
# ---------------------------------------------------------------------------

def pad_for_mesh(geno: np.ndarray, win_missing: np.ndarray,
                 mesh) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad [I, L] genotypes and the [L] window-missing mask so both axes
    divide the mesh; returns (geno, win_missing, ind_weight).

    Padding individuals are all-missing (-9, excluded from freq) with
    ind_weight 0 (excluded from KDE/GMM); padded loci get missing=True
    windows."""
    n_dp = mesh.shape[AXIS_DP]
    n_sp = mesh.shape[AXIS_SP]
    I, L = geno.shape
    I2 = -(-I // n_dp) * n_dp
    L2 = -(-L // n_sp) * n_sp
    iw = np.zeros(I2, dtype=np.float32)
    iw[:I] = 1.0
    if I2 != I or L2 != L:
        g = np.full((I2, L2), -9, dtype=np.int8)
        g[:I, :L] = geno
        m = np.ones(L2, dtype=bool)
        m[:L] = win_missing
        return g, m, iw
    return geno, win_missing, iw


def pad_local_for_mesh(geno_local: np.ndarray, win_missing: np.ndarray,
                       mesh, nind_global: int):
    """Per-host column-range analog of pad_for_mesh: pad THIS host's
    [I_loc, L] row block to its full dp-row slot [I2/num_hosts, L2]
    (all-missing pad rows; only the last host's block is ever short) and
    the [L] mask to L2.  The padded global layout matches pad_for_mesh's
    exactly, so make_array_from_process_local_data reassembles the same
    array the full-panel path would device_put."""
    import jax

    n_dp = mesh.shape[AXIS_DP]
    n_sp = mesh.shape[AXIS_SP]
    p = jax.process_count()
    I_loc, L = geno_local.shape
    I2 = -(-nind_global // n_dp) * n_dp
    per = I2 // p
    L2 = -(-L // n_sp) * n_sp
    if I_loc != per or L2 != L:
        g = np.full((per, L2), -9, dtype=np.int8)
        g[:I_loc, :L] = geno_local
    else:
        g = geno_local
    m = np.ones(L2, dtype=bool)
    m[:L] = win_missing
    return g, m


def full_window_missing(positions: np.ndarray, winsize: int, max_gap: int,
                        cstart: int, cend: int) -> np.ndarray:
    """[L] bool mask: window-missing per start locus, True past nwin."""
    from ..ops.lod import window_missing_mask
    L = positions.shape[0]
    nwin = max(L - winsize + 1, 0)
    m = np.ones(L, dtype=bool)
    m[:nwin] = window_missing_mask(positions, winsize, max_gap, cstart, cend)
    return m
