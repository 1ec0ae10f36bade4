"""Device-resident weighted path: banded LD + wLOD window scan (fast engine).

The reference's weighted run is dominated by the LD matrix —
O(L * W^2 * I_sub) with pthread fan-out (src/garlic-data.cpp:330-646) —
and a non-rolling wLOD window sum O(I * L * W) (src/garlic-roh.cpp:241-276).
On the device both become banded vector ops:

* pair band P[m, d] = ld(m, m+d): per-offset elementwise AND/counts reduced
  over individuals (VPU, O(L*W*I) total — the W^2 recomputation is gone);
* LD band assembly via the cumsum decomposition
  LD[l][j] = 1 + D[l+j, j] + S[l+j, W-1-j] (O(L*W));
* wLOD windows: W unrolled FMAs win[l] += score[l+j] * (1/LD[l][j]).

All f32 on device (fast-engine contract); the f64 numpy engine in ops/ld.py
and ops/wlod.py remains the byte-exact path.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from ..core.types import MISSING
from .device_cache import (_bucket, _device_cache_get, _device_cache_put,
                           _device_plane, device_packed_keyed)
from .device_win import DeviceWin


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _hr2_band(geno_sub, hom_freq, winsize: int):
    """P [L, W] f32: HR^2 between m and m+d (d in [1, W-1]).

    Joint hom-hom counts over the (sub)panel; marginal homozygosity
    frequencies from the full panel (src/garlic-data.cpp:558-583)."""
    import jax.numpy as jnp
    I, L = geno_sub.shape
    valid = (geno_sub != -9)
    homv = valid & (geno_sub != 1)
    HA = hom_freq
    ok = (HA > 0) & (HA < 1)
    denom = HA * (1.0 - HA)
    vf = valid.astype(jnp.float32)
    hf = homv.astype(jnp.float32)
    cols = []
    zero_col = jnp.zeros((L,), jnp.float32)
    cols.append(zero_col)  # d = 0 slot unused
    for d in range(1, winsize):
        if d >= L:
            cols.append(zero_col)
            continue
        total = jnp.sum(vf[:, :-d] * vf[:, d:], axis=0)
        hab = jnp.sum(hf[:, :-d] * hf[:, d:], axis=0)
        hab = hab / total
        h = hab - HA[:-d] * HA[d:]
        hr2 = (h * h) / (denom[:-d] * denom[d:])
        hr2 = jnp.minimum(hr2, 1.0)
        hr2 = jnp.where(ok[:-d] & ok[d:], hr2, 0.0)
        hr2 = jnp.where(jnp.isfinite(hr2), hr2, 0.0)
        cols.append(jnp.concatenate([hr2, jnp.zeros((d,), jnp.float32)]))
    return jnp.stack(cols, axis=1)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _r2_band(geno_sub, fc_sub, freq, winsize: int):
    """P [L, W] f32: phased r^2 (src/garlic-data.cpp:585-617)."""
    import jax.numpy as jnp
    I, L = geno_sub.shape
    valid = (geno_sub != -9)
    p = freq
    ok = (p > 0) & (p < 1)
    denom = p * (1.0 - p)
    g2 = (geno_sub == 2)
    g1 = (geno_sub == 1)
    cols = [jnp.zeros((L,), jnp.float32)]
    for d in range(1, winsize):
        if d >= L:
            cols.append(cols[0])
            continue
        bv = valid[:, :-d] & valid[:, d:]
        a2, b2 = g2[:, :-d], g2[:, d:]
        a1, b1 = g1[:, :-d], g1[:, d:]
        same = fc_sub[:, :-d] == fc_sub[:, d:]
        x11 = (2 * (a2 & b2) + (a1 & b2) + (a2 & b1)
               + (a1 & b1 & same)).astype(jnp.float32)
        x11 = jnp.sum(jnp.where(bv, x11, 0.0), axis=0)
        total = 2.0 * jnp.sum(bv.astype(jnp.float32), axis=0)
        x11 = x11 / total
        D = x11 - p[:-d] * p[d:]
        r2 = (D * D) / (denom[:-d] * denom[d:])
        r2 = jnp.minimum(r2, 1.0)
        r2 = jnp.where(ok[:-d] & ok[d:], r2, 0.0)
        r2 = jnp.where(jnp.isfinite(r2), r2, 0.0)
        cols.append(jnp.concatenate([r2, jnp.zeros((d,), jnp.float32)]))
    return jnp.stack(cols, axis=1)


def _hbm_budget() -> float:
    """Usable HBM bytes (shared helper: see runtime.hbm_budget)."""
    from ..runtime import hbm_budget
    return hbm_budget()


def _fused_peak_estimate(I: int, L2: int, winsize: int) -> float:
    """Compile-time device-memory peak of the fused weighted program,
    estimated as ~26x the [I, L2] f32 plane at W=60 (the decode int32
    temporaries, the nested where-select score, and the unrolled window
    sum each hold several full planes live).  A mild W term keeps large
    winsizes conservative: over-estimating only routes to the chunked
    path, which computes bit-identical values."""
    return (16.0 + winsize / 5.0) * I * L2 * 4.0


@partial(__import__("jax").jit)
def _hom_freq_dev(g_full):
    """Per-locus homozygosity frequency of the FULL panel, on device
    (calculateGenoFreq, src/garlic-data.cpp:656-676): counts are exact
    integers in f32 (I < 2^24), total==0 -> 0 (the host path's nan is
    nan_to_num'd to 0 before use anyway).  Keeps the packed-only
    chromosome packed: the host int8 matrix never materializes for the
    marginals."""
    import jax.numpy as jnp
    valid = (g_full != -9)
    hom = valid & (g_full != 1)
    total = jnp.sum(valid.astype(jnp.float32), axis=0)
    homs = jnp.sum(hom.astype(jnp.float32), axis=0)
    return jnp.where(total > 0, homs / total, 0.0)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _assemble_band(P, winsize: int):
    """LD [L, W] from the pair band (cumsum decomposition, see
    ops/ld.py assemble_ld_fast)."""
    import jax.numpy as jnp
    L, W = P.shape
    nwin = L - W + 1
    S = jnp.cumsum(P, axis=1)                       # S[m, j] = sum_{d<=j}
    # D[m, j] = sum_{d=1}^{j} P[m-d, d] built iteratively
    prev = jnp.zeros((L,), P.dtype)
    outs = [prev]
    for j in range(1, W):
        shifted = jnp.concatenate(
            [jnp.zeros((j,), P.dtype), P[:-j, j]]) if j < L else \
            jnp.zeros((L,), P.dtype)
        prev = prev + shifted
        outs.append(prev)
    D = jnp.stack(outs, axis=1)
    cols = []
    for j in range(W):
        # m = l + j with l in [0, nwin): a STATIC slice, not a gather —
        # advanced indexing here would lower to a gather; slices are free
        cols.append(1.0 + D[j:j + nwin, j] + S[j:j + nwin, W - 1 - j])
    LD = jnp.stack(cols, axis=1)                    # [nwin, W]
    pad = jnp.zeros((L - nwin, W), P.dtype)
    return jnp.concatenate([LD, pad], axis=0)


def ld_band_device(chrom, winsize: int, phased: bool,
                   sub_idx: Optional[np.ndarray] = None):
    """Full [L2 >= L, W] LD matrix on device (calcLDData per-chr step).

    Loci are padded to a power-of-two bucket with missing genotypes
    (freq/hom-freq 0 -> pairwise LD 0 there) so one compiled program
    serves every chromosome length; rows >= nwin are never read by the
    wLOD window sum.

    Only the band's rows (the LD subsample) are ever decoded to int8 —
    the genotypes live as 2-bit bytes and the subsample row-gather
    happens on the packed matrix.  When even the subsample (or the
    full-panel hom-freq marginal pass) would exceed the HBM budget,
    pair counts accumulate over individual chunks: counts are exact
    integers in f32, so the chunked band is bit-identical to the
    one-shot band."""
    import jax.numpy as jnp
    from .ld import geno_hom_freq
    I, L = chrom.nind, chrom.nloci
    L2 = _bucket(L)
    budget = _hbm_budget()
    pk = _device_packed(chrom)
    sub = None if sub_idx is None else np.asarray(sub_idx, dtype=np.int32)
    nsub = I if sub is None else int(sub.shape[0])
    pk_sub = pk if sub is None else pk[jnp.asarray(sub)]
    # a [n, L2] decode + band holds ~24 n*L2 bytes of int32/f32
    # temporaries at compile-time peak
    small_band = 24.0 * nsub * L2 <= 0.5 * budget
    if phased:
        fc = chrom.first_copy if sub is None else chrom.first_copy[sub]
        fp = np.zeros(L2, dtype=np.float32)
        fp[:L] = np.asarray(chrom.freq, dtype=np.float32)
        if small_band:
            fcp = np.zeros((nsub, L2), dtype=bool)
            fcp[:, :L] = fc
            g_sub = _int8_from_packed(pk_sub, nsub, L, L2)
            P = _r2_band(g_sub, jnp.asarray(fcp), jnp.asarray(fp), winsize)
        else:
            P = _r2_band_chunked(pk_sub, fc, jnp.asarray(fp), nsub, L, L2,
                                 winsize, budget)
    else:
        if chrom.geno_is_packed_only:
            if 24.0 * I * L2 <= 0.5 * budget:
                # marginals from a full-panel decode on device — the
                # host int8 matrix never materializes
                hf_dev = _hom_freq_dev(_int8_from_packed(pk, I, L, L2))
            else:
                hf_dev = _hom_freq_chunked(pk, I, L, L2, budget)
        else:
            hf = geno_hom_freq(chrom.genotypes)   # full-panel marginals
            hp = np.zeros(L2, dtype=np.float32)
            hp[:L] = np.nan_to_num(hf)
            hf_dev = jnp.asarray(hp)
        if small_band:
            g_sub = _int8_from_packed(pk_sub, nsub, L, L2)
            P = _hr2_band(g_sub, hf_dev, winsize)
        else:
            P = _hr2_band_chunked(pk_sub, hf_dev, nsub, L, L2, winsize,
                                  budget)
    return _assemble_band(P, winsize)


def _row_chunks(n: int, budget: float, L2: int,
                bytes_per_cell: float) -> int:
    """Rows per chunk so one chunk's working set stays well under the
    budget; multiple of 8, at least 8."""
    c = int((0.25 * budget) // (bytes_per_cell * L2))
    c = max(8, min(n, c - (c % 8) if c >= 8 else 8))
    return c


def _iter_pk_chunks(pk_rows, n: int, C: int):
    """Yield [C, ...] packed-row blocks; the last block is padded with
    0xFF rows (2-bit code 3 everywhere = all-missing) so one compiled
    program serves every chunk.  Pad rows contribute nothing to counts
    and their scores are sliced away by callers."""
    import jax.numpy as jnp
    for s in range(0, n, C):
        blk = pk_rows[s:s + C]
        if blk.shape[0] < C:
            pad = jnp.full((C - blk.shape[0], pk_rows.shape[1]), 255,
                           pk_rows.dtype)
            blk = jnp.concatenate([blk, pad])
        yield blk


@partial(__import__("jax").jit, static_argnames=("C", "L", "L2", "winsize"))
def _hr2_counts_chunk(pk_c, C: int, L: int, L2: int, winsize: int):
    """Per-offset pair counts over one row chunk: (total, hom-hom) both
    [L2, W] f32 exact integers (entries past L2-d are 0)."""
    import jax.numpy as jnp
    g = _int8_from_packed(pk_c, C, L, L2)
    valid = (g != -9)
    homv = valid & (g != 1)
    vf = valid.astype(jnp.float32)
    hf = homv.astype(jnp.float32)
    zero = jnp.zeros((L2,), jnp.float32)
    tcols, hcols = [zero], [zero]
    for d in range(1, winsize):
        if d >= L2:
            tcols.append(zero)
            hcols.append(zero)
            continue
        t = jnp.sum(vf[:, :-d] * vf[:, d:], axis=0)
        h = jnp.sum(hf[:, :-d] * hf[:, d:], axis=0)
        pad = jnp.zeros((d,), jnp.float32)
        tcols.append(jnp.concatenate([t, pad]))
        hcols.append(jnp.concatenate([h, pad]))
    return jnp.stack(tcols, axis=1), jnp.stack(hcols, axis=1)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _hr2_finalize(T, H, HA, winsize: int):
    """HR^2 band from accumulated counts — the per-d math is the same
    expression sequence as _hr2_band, so the result is bit-identical
    (the count sums themselves are exact integers in f32)."""
    import jax.numpy as jnp
    L2 = T.shape[0]
    ok = (HA > 0) & (HA < 1)
    denom = HA * (1.0 - HA)
    zero = jnp.zeros((L2,), jnp.float32)
    cols = [zero]
    for d in range(1, winsize):
        if d >= L2:
            cols.append(zero)
            continue
        hab = H[:-d, d] / T[:-d, d]
        h = hab - HA[:-d] * HA[d:]
        hr2 = (h * h) / (denom[:-d] * denom[d:])
        hr2 = jnp.minimum(hr2, 1.0)
        hr2 = jnp.where(ok[:-d] & ok[d:], hr2, 0.0)
        hr2 = jnp.where(jnp.isfinite(hr2), hr2, 0.0)
        cols.append(jnp.concatenate([hr2, jnp.zeros((d,), jnp.float32)]))
    return jnp.stack(cols, axis=1)


def _hr2_band_chunked(pk_rows, hf_dev, n: int, L: int, L2: int,
                      winsize: int, budget: float):
    C = _row_chunks(n, budget, L2, 24.0)
    T = H = None
    for blk in _iter_pk_chunks(pk_rows, n, C):
        t, h = _hr2_counts_chunk(blk, C, L, L2, winsize)
        T = t if T is None else T + t
        H = h if H is None else H + h
    return _hr2_finalize(T, H, hf_dev, winsize)


@partial(__import__("jax").jit, static_argnames=("C", "L2"))
def _bool_from_packed(pb, C: int, L2: int):
    """[C, L2] bool from bit-packed rows (little-endian packbits)."""
    import jax.numpy as jnp
    d = pb.astype(jnp.int32)
    bits = [(d >> k) & 1 for k in range(8)]
    return jnp.stack(bits, axis=2).reshape(C, -1)[:, :L2] != 0


@partial(__import__("jax").jit, static_argnames=("C", "L", "L2", "winsize"))
def _r2_counts_chunk(pk_c, fcb, C: int, L: int, L2: int, winsize: int):
    """Phased pair counts over one row chunk: (2*valid-pair count, x11
    haplotype count) both [L2, W] f32 exact integers."""
    import jax.numpy as jnp
    g = _int8_from_packed(pk_c, C, L, L2)
    fc = _bool_from_packed(fcb, C, L2)
    valid = (g != -9)
    g2 = (g == 2)
    g1 = (g == 1)
    zero = jnp.zeros((L2,), jnp.float32)
    tcols, xcols = [zero], [zero]
    for d in range(1, winsize):
        if d >= L2:
            tcols.append(zero)
            xcols.append(zero)
            continue
        bv = valid[:, :-d] & valid[:, d:]
        a2, b2 = g2[:, :-d], g2[:, d:]
        a1, b1 = g1[:, :-d], g1[:, d:]
        same = fc[:, :-d] == fc[:, d:]
        x11 = (2 * (a2 & b2) + (a1 & b2) + (a2 & b1)
               + (a1 & b1 & same)).astype(jnp.float32)
        x11 = jnp.sum(jnp.where(bv, x11, 0.0), axis=0)
        total = 2.0 * jnp.sum(bv.astype(jnp.float32), axis=0)
        pad = jnp.zeros((d,), jnp.float32)
        tcols.append(jnp.concatenate([total, pad]))
        xcols.append(jnp.concatenate([x11, pad]))
    return jnp.stack(tcols, axis=1), jnp.stack(xcols, axis=1)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _r2_finalize(T, X, p, winsize: int):
    """r^2 band from accumulated counts (same expression sequence as
    _r2_band -> bit-identical)."""
    import jax.numpy as jnp
    L2 = T.shape[0]
    ok = (p > 0) & (p < 1)
    denom = p * (1.0 - p)
    zero = jnp.zeros((L2,), jnp.float32)
    cols = [zero]
    for d in range(1, winsize):
        if d >= L2:
            cols.append(zero)
            continue
        x11 = X[:-d, d] / T[:-d, d]
        D = x11 - p[:-d] * p[d:]
        r2 = (D * D) / (denom[:-d] * denom[d:])
        r2 = jnp.minimum(r2, 1.0)
        r2 = jnp.where(ok[:-d] & ok[d:], r2, 0.0)
        r2 = jnp.where(jnp.isfinite(r2), r2, 0.0)
        cols.append(jnp.concatenate([r2, jnp.zeros((d,), jnp.float32)]))
    return jnp.stack(cols, axis=1)


def _r2_band_chunked(pk_rows, fc, fp_dev, n: int, L: int, L2: int,
                     winsize: int, budget: float):
    import jax.numpy as jnp
    C = _row_chunks(n, budget, L2, 24.0)
    fcp = np.zeros((n, L2), dtype=bool)
    fcp[:, :L] = fc
    fcb = np.packbits(fcp, axis=1, bitorder="little")
    T = X = None
    s = 0
    for blk in _iter_pk_chunks(pk_rows, n, C):
        fblk = fcb[s:s + C]
        if fblk.shape[0] < C:
            fblk = np.concatenate(
                [fblk, np.zeros((C - fblk.shape[0], fcb.shape[1]),
                                fcb.dtype)])
        t, x = _r2_counts_chunk(blk, jnp.asarray(fblk), C, L, L2, winsize)
        T = t if T is None else T + t
        X = x if X is None else X + x
        s += C
    return _r2_finalize(T, X, fp_dev, winsize)


@partial(__import__("jax").jit, static_argnames=("C", "L", "L2"))
def _hom_counts_chunk(pk_c, C: int, L: int, L2: int):
    import jax.numpy as jnp
    g = _int8_from_packed(pk_c, C, L, L2)
    valid = (g != -9)
    hom = valid & (g != 1)
    return (jnp.sum(valid.astype(jnp.float32), axis=0),
            jnp.sum(hom.astype(jnp.float32), axis=0))


def _hom_freq_chunked(pk, I: int, L: int, L2: int, budget: float):
    """Full-panel homozygosity marginals accumulated over row chunks
    (exact integer counts -> identical to the one-shot _hom_freq_dev)."""
    import jax.numpy as jnp
    C = _row_chunks(I, budget, L2, 24.0)
    tot = hom = None
    for blk in _iter_pk_chunks(pk, I, C):
        t, h = _hom_counts_chunk(blk, C, L, L2)
        tot = t if tot is None else tot + t
        hom = h if hom is None else hom + h
    return jnp.where(tot > 0, hom / tot, 0.0)


@partial(__import__("jax").jit, static_argnames=("I", "L", "L2"))
def _wlod_score_from_table(p2, table, I: int, L: int, L2: int):
    """score [I, L2] f32 on device from 2-bit genotype bytes + a [4, L2]
    per-class table of lod*nomut*norec.  The gather reproduces the host
    formulation bit-for-bit in f32 (same f64 products, cast once), while
    the H2D payload shrinks from the [I, L] f32 score matrix (~80 MB per
    200x100k chromosome) to ~I*L/4 genotype bytes + 16*L table bytes
    (~6 MB)."""
    import jax.numpy as jnp
    d = p2.astype(jnp.int32)
    digs = [(d >> (2 * k)) & 3 for k in range(4)]
    g = jnp.stack(digs, axis=2).reshape(I, -1)[:, :L]
    g = jnp.concatenate([g, jnp.full((I, L2 - L), 3, g.dtype)], axis=1)
    # per-class select instead of take_along_axis: three vectorized
    # selects over broadcast rows pick the identical values without a
    # gather
    t0r, t1r, t2r, t3r = table[0], table[1], table[2], table[3]
    return jnp.where(g == 0, t0r[None, :],
                     jnp.where(g == 1, t1r[None, :],
                               jnp.where(g == 2, t2r[None, :],
                                         t3r[None, :])))


def _device_packed(chrom):
    return device_packed_keyed(chrom)[0]


@partial(__import__("jax").jit, static_argnames=("I", "L", "L2"))
def _int8_from_packed(p2, I: int, L: int, L2: int):
    """[I, L2] int8 genotypes (0/1/2/-9, -9 pad) decoded on device from
    2-bit bytes — feeds the existing _hr2_band/_r2_band jits with the
    exact values the host int8 ship produced, so the band numerics are
    unchanged."""
    import jax.numpy as jnp
    d = p2.astype(jnp.int32)
    digs = [(d >> (2 * k)) & 3 for k in range(4)]
    g = jnp.stack(digs, axis=2).reshape(I, -1)[:, :L]
    g = jnp.concatenate([g, jnp.full((I, L2 - L), 3, g.dtype)], axis=1)
    return jnp.where(g == 3, -9, g).astype(jnp.int8)


def _decay_factors(chrom, mu: float, M: int):
    """(nomut, norec) [L] f64 per wlod_scores (src/garlic-roh.cpp:134-141)."""
    pos = chrom.positions.astype(np.float64)
    gpos = chrom.gpos.astype(np.float64)
    dpos = np.empty_like(pos)
    dpos[0] = pos[0]
    dpos[1:] = pos[1:] - pos[:-1]
    dg = np.empty_like(gpos)
    dg[0] = gpos[0]
    dg[1:] = gpos[1:] - gpos[:-1]
    return np.exp(-2.0 * M * mu * dpos), np.exp(-2.0 * M * 1.0 * dg)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _wlod_windows_dev(score, inv_ld, missing, winsize: int):
    """(win [I, NW2] f32 (padded window-start layout): for each start l,
    Σ_j score[:, l+j] * inv_ld[l, j], masked by missing [1, NW2] int8;
    tie_scale f32 scalar = max finite |term| — the data-driven scale of
    the tie-patrol band, since 1/LD can amplify terms arbitrarily)."""
    import jax.numpy as jnp
    I, L2 = score.shape
    nw2 = L2 - winsize + 1
    acc = jnp.zeros((I, nw2), jnp.float32)
    tmax = jnp.float32(0.0)
    for j in range(winsize):
        t = score[:, j:j + nw2] * inv_ld[:nw2, j][None, :]
        acc = acc + t
        tmax = jnp.maximum(
            tmax, jnp.max(jnp.where(jnp.isfinite(t), jnp.abs(t), 0.0)))
    return jnp.where(missing != 0, jnp.float32(MISSING), acc), tmax


@partial(__import__("jax").jit,
         static_argnames=("I", "L", "L2", "winsize"))
def _fused_unphased(pk, aux, sub_idx, I: int, L: int, L2: int,
                    winsize: int):
    """The ENTIRE unphased scalar-error weighted Phase I as ONE program:
    2-bit decode -> full-panel hom freqs -> LD-subsample row gather ->
    HR^2 pair band -> LD band assembly -> reciprocal -> per-class score
    gather -> weighted window sum.

    Fusing matters for latency, not FLOPs: every executable launch and
    every host array upload is a separate host round trip, so one jit +
    one packed `aux` upload (2 round trips) replaces an 8-dispatch /
    3-upload chain.

    aux [5, L2] f32: rows 0..3 = lod*nomut*norec per genotype class
    (missing-class row 3), row 4 = window-missing flags (nonzero = window
    MISSING) in window-start layout, zero-padded past nw2."""
    import jax.numpy as jnp
    g_full = _int8_from_packed(pk, I, L, L2)
    hf = _hom_freq_dev(g_full)
    gsub = g_full[sub_idx]
    P = _hr2_band(gsub, hf, winsize)
    inv_ld = 1.0 / _assemble_band(P, winsize)
    score = _wlod_score_from_table(pk, aux[:4], I, L, L2)
    nw2 = L2 - winsize + 1
    return _wlod_windows_dev(score, inv_ld, aux[4:5, :nw2], winsize)


@partial(__import__("jax").jit,
         static_argnames=("I", "L", "L2", "winsize"))
def _fused_phased(pk, aux, sub_idx, fcp_sub, I: int, L: int, L2: int,
                  winsize: int):
    """_fused_unphased for phased panels: r^2 from the subsample's
    first-copy bits + full-panel allele freqs (aux row 5).  Like
    _fused_unphased, returns (win, tie_scale) via _wlod_windows_dev."""
    import jax.numpy as jnp
    g_full = _int8_from_packed(pk, I, L, L2)
    gsub = g_full[sub_idx]
    P = _r2_band(gsub, fcp_sub, aux[5], winsize)
    inv_ld = 1.0 / _assemble_band(P, winsize)
    score = _wlod_score_from_table(pk, aux[:4], I, L, L2)
    nw2 = L2 - winsize + 1
    return _wlod_windows_dev(score, inv_ld, aux[4:5, :nw2], winsize)


def _weighted_aux(chrom, centro, winsize: int, error, max_gap: int,
                  mu: float, M: int, L2: int, phased: bool):
    """One packed [5|6, L2] f32 host array carrying every per-locus input
    the fused kernels need — a single H2D round trip."""
    from .lod import lod_table, window_missing_mask
    L = chrom.nloci
    nwin = L - winsize + 1
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    nomut, norec = _decay_factors(chrom, mu, M)
    # reference order: (lod * nomut) * norec (src/garlic-roh.cpp:249)
    t = (lod_table(chrom.freq, error) * nomut[None, :]) * norec[None, :]
    aux = np.zeros((6 if phased else 5, L2), dtype=np.float32)
    aux[:4, :L] = t.astype(np.float32)
    nw2 = L2 - winsize + 1
    aux[4, :nw2] = 1.0
    aux[4, :nwin] = missing.astype(np.float32)
    if phased:
        aux[5, :L] = np.asarray(chrom.freq, dtype=np.float32)
    return aux, nwin


@partial(__import__("jax").jit,
         static_argnames=("C", "L", "L2", "winsize"))
def _wlod_chunk(pk_c, table4, inv_ld, missing_row, C: int, L: int, L2: int,
                winsize: int):
    """Score gather + weighted window sum for one row chunk — the
    row-independent two-thirds of _fused_unphased, so chunk outputs are
    bit-identical to the fused program's rows."""
    score = _wlod_score_from_table(pk_c, table4, C, L, L2)
    return _wlod_windows_dev(score, inv_ld, missing_row, winsize)


def weighted_windows_device(chrom, centro, winsize: int, error,
                            max_gap: int, use_gl: bool, mu: float, M: int,
                            phased: bool,
                            sub_idx: Optional[np.ndarray] = None
                            ) -> DeviceWin:
    """Weighted Phase I (LD band + wLOD windows) -> DeviceWin in ONE
    device dispatch + one aux upload (see _fused_unphased).  TGLS runs
    (per-(ind, locus) error) fall back to the two-step path — the [I, L]
    score matrix genuinely has to ship.

    When the fused program's compile-time memory peak would not fit
    the budget (runtime.hbm_budget), the same math runs as LD band once
    + per-individual-chunk score/window dispatches — bit-identical rows,
    a few extra host round trips."""
    import jax.numpy as jnp
    I, L = chrom.nind, chrom.nloci
    if use_gl or L - winsize + 1 <= 0:
        ld_dev = ld_band_device(chrom, winsize, phased, sub_idx)
        return wlod_windows_device(chrom, centro, ld_dev, winsize, error,
                                   max_gap, use_gl, mu, M)
    L2 = _bucket(L)
    nwin = L - winsize + 1
    budget = _hbm_budget()
    if _fused_peak_estimate(I, L2, winsize) > budget:
        return _weighted_windows_chunked(chrom, centro, winsize, error,
                                         max_gap, mu, M, phased, sub_idx,
                                         L2, budget)
    pk, pkkey = device_packed_keyed(chrom)
    aux_dev = _aux_dev_cached(chrom, centro, winsize, error, max_gap,
                              mu, M, L2, phased, pkkey)
    sub = (np.arange(I, dtype=np.int32) if sub_idx is None
           else np.asarray(sub_idx, dtype=np.int32))
    sub_dev = jnp.asarray(sub)
    if phased:
        from ..core.digest import content_digest
        fkey = (pkkey, "wfc", content_digest(np.ascontiguousarray(sub)),
                content_digest(np.ascontiguousarray(chrom.first_copy)), L2)
        fhit = _device_cache_get(fkey)
        if fhit is not None and fhit[0] == "wfc":
            fcp_dev = fhit[1]
        else:
            fc = chrom.first_copy if sub_idx is None \
                else chrom.first_copy[sub_idx]
            fcp = np.zeros((fc.shape[0], L2), dtype=bool)
            fcp[:, :L] = fc
            fcp_dev = jnp.asarray(fcp)
            _device_cache_put(fkey, ("wfc", fcp_dev))
        win, tsc = _fused_phased(pk, aux_dev, sub_dev, fcp_dev,
                                 I, L, L2, winsize)
    else:
        win, tsc = _fused_unphased(pk, aux_dev, sub_dev, I, L, L2, winsize)
    return DeviceWin(win=win, nind=I, nloci=L, nwin=nwin, tie_scale=tsc)


def _aux_dev_cached(chrom, centro, winsize: int, error, max_gap: int,
                    mu: float, M: int, L2: int, phased: bool, pkkey):
    """Content-keyed device residency for the weighted aux planes, so a
    warm weighted run uploads nothing.  The key covers everything the planes are built
    from: genotype content (pkkey), freq/positions/gpos content, and
    the scalar parameters.  Shared by the fused and the chunked
    (large-panel) weighted paths so both skip the upload warm."""
    import jax.numpy as jnp
    from ..core.digest import content_digest
    akey = (pkkey, "waux",
            content_digest(np.ascontiguousarray(chrom.freq)),
            content_digest(np.ascontiguousarray(chrom.positions)),
            content_digest(np.ascontiguousarray(chrom.gpos)),
            winsize, float(error), int(max_gap), float(mu), int(M),
            int(centro.start(chrom.chrom)), int(centro.end(chrom.chrom)),
            bool(phased), L2)
    hit = _device_cache_get(akey)
    if hit is not None and hit[0] == "waux":
        return hit[1]
    aux, _ = _weighted_aux(chrom, centro, winsize, error, max_gap,
                           mu, M, L2, phased)
    aux_dev = jnp.asarray(aux)
    _device_cache_put(akey, ("waux", aux_dev))
    return aux_dev


def _weighted_windows_chunked(chrom, centro, winsize: int, error,
                              max_gap: int, mu: float, M: int,
                              phased: bool, sub_idx, L2: int,
                              budget: float) -> DeviceWin:
    """Large-panel scalar-error weighted Phase I: one LD band + chunked
    score/window dispatches (see weighted_windows_device)."""
    import jax.numpy as jnp
    I, L = chrom.nind, chrom.nloci
    nwin = L - winsize + 1
    inv_ld = 1.0 / ld_band_device(chrom, winsize, phased, sub_idx)
    pk, pkkey = device_packed_keyed(chrom)
    aux_dev = _aux_dev_cached(chrom, centro, winsize, error, max_gap,
                              mu, M, L2, phased, pkkey)
    table4 = aux_dev[:4]                    # device slices, no re-upload
    nw2 = L2 - winsize + 1
    missing_row = aux_dev[4:5, :nw2]
    # per-row working set ~ the fused estimate's per-row cost; keep a
    # chunk at ~1/4 budget so the [I, nw2] output + band fit alongside
    C = _row_chunks(I, budget, L2, (16.0 + winsize / 5.0) * 4.0)
    parts = [_wlod_chunk(blk, table4, inv_ld, missing_row,
                         C, L, L2, winsize)
             for blk in _iter_pk_chunks(pk, I, C)]
    wins = [w for w, _ in parts]
    tsc = parts[0][1]
    for _, t in parts[1:]:
        tsc = jnp.maximum(tsc, t)
    win = jnp.concatenate(wins, axis=0)[:I] if len(wins) > 1 \
        else wins[0][:I]
    return DeviceWin(win=win, nind=I, nloci=L, nwin=nwin, tie_scale=tsc)


def wlod_windows_device(chrom, centro, ld_dev, winsize: int, error,
                        max_gap: int, use_gl: bool, mu: float,
                        M: int) -> DeviceWin:
    """Weighted Phase-I on device -> DeviceWin (no host transfer).

    Scalar-error runs ship 2-bit genotypes + a [4, L] class table and
    gather the per-locus scores on device (_wlod_score_from_table);
    TGLS runs have a genuinely per-(ind, locus) error so the [I, L]
    score matrix still ships."""
    import jax.numpy as jnp
    from .lod import window_missing_mask
    I, L = chrom.nind, chrom.nloci
    nwin = L - winsize + 1
    if nwin <= 0:
        win = jnp.full((I, L), jnp.float32(MISSING))
        return DeviceWin(win=win, nind=I, nloci=L)
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    # pad to the LD band's bucketed length (scores 0 there; masked anyway)
    L2 = ld_dev.shape[0]
    nw2 = L2 - winsize + 1
    mp = np.ones((1, nw2), dtype=np.int8)
    mp[0, :nwin] = missing.astype(np.int8)
    inv_ld = 1.0 / ld_dev
    if use_gl:
        # TGLS: the score is genuinely per-(ind, locus), so the [I, L2]
        # f32 plane has to ship once — but it is a pure function of the
        # panel content + (mu, M), so it lives in the content-addressed
        # HBM cache and warm weighted-TGLS runs (parameter sweeps, the
        # auto-winsize loop) skip the dominant upload entirely.
        from ..core.digest import content_digest
        gsrc = (chrom.gl_codes if chrom.gl_codes is not None
                else np.ascontiguousarray(chrom.gl))
        lutd = (content_digest(np.ascontiguousarray(chrom.gl_lut))
                if chrom.gl_codes is not None else None)
        skey = ("wglscore",
                content_digest(np.ascontiguousarray(chrom.genotypes)),
                content_digest(np.ascontiguousarray(gsrc)), lutd,
                content_digest(np.ascontiguousarray(chrom.freq)),
                content_digest(np.ascontiguousarray(chrom.positions)),
                content_digest(np.ascontiguousarray(chrom.gpos)),
                float(mu), int(M), L2)
        hit = _device_cache_get(skey)
        if hit is not None and hit[0] == "wglscore":
            score_dev = hit[1]
        else:
            from .wlod import wlod_scores
            score = wlod_scores(chrom, error, use_gl, mu,
                                M).astype(np.float32)
            sp = np.zeros((I, L2), dtype=np.float32)
            sp[:, :L] = score
            score_dev = jnp.asarray(sp)
            _device_cache_put(skey, ("wglscore", score_dev))
    else:
        from .lod import lod_table
        nomut, norec = _decay_factors(chrom, mu, M)
        # reference order: (lod * nomut) * norec (src/garlic-roh.cpp:249)
        t = (lod_table(chrom.freq, error) * nomut[None, :]) * norec[None, :]
        tp = np.zeros((4, L2), dtype=np.float32)
        tp[:, :L] = t.astype(np.float32)
        score_dev = _wlod_score_from_table(
            _device_packed(chrom), jnp.asarray(tp), I, L, L2)
    win, tsc = _wlod_windows_dev(score_dev, inv_ld, _device_plane(mp),
                                 winsize)
    return DeviceWin(win=win, nind=I, nloci=L, nwin=nwin, tie_scale=tsc)
