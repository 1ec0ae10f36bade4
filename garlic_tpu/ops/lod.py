"""Phase I: sliding-window LOD autozygosity scoring.

The reference computes, per (individual, window-start), the sum over a
winsize-SNP window of per-genotype log10 likelihood ratios
(src/garlic-roh.cpp:18-132,355-386), with a rolling-sum update and
gap/centromere masking.  Windows overlapping a >MAX_GAP inter-SNP gap or the
centromere are MISSING.

Two engines:

* exact  — float64, reproducing the reference's summation order bit-for-bit
           (fresh left-to-right sum at the start of each non-missing run,
           then win[l] = (win[l-1] - a[l-1]) + a[l+W-1]).  Dispatches to the
           C++ native kernel when built; numpy fallback otherwise.
* fast   — float32 JAX path: per-locus LOD terms from a 3-row table
           (elementwise selects, no gathers), window sums by exact
           shifted-add doubling (true f32 adds, no convolution or matrix
           product, so no reduced-precision accumulation), masks
           precomputed from positions and shared across individuals.

The mask formulation is provably equivalent to the reference's skip-ahead
control flow: window l is MISSING iff its first locus lies inside the
centromere or any adjacent pair (i-1, i), l < i <= l+W-1, violates the gap/
centromere test (see tests/test_lod.py for the property test against a
transliterated scalar implementation).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from ..core.types import MISSING


# ---------------------------------------------------------------------------
# Per-genotype LOD terms (reference lod(), src/garlic-roh.cpp:355-386)
# ---------------------------------------------------------------------------

def lod_terms(geno: np.ndarray, freq: np.ndarray,
              error, dtype=np.float64) -> np.ndarray:
    """Elementwise lod(genotype, freq, error) over [I, L].

    `error` is a scalar or an [I, L] array (TGLS per-genotype error).
    Branch-free evaluation with the reference's exact operation order per
    branch so float64 results are bit-identical to the C++ scalar code."""
    geno = np.asarray(geno)
    freq = np.asarray(freq, dtype=np.float64)
    e = np.asarray(error, dtype=np.float64)
    one_minus = 1.0 - freq
    with np.errstate(divide="ignore", invalid="ignore"):
        non0 = one_minus * one_minus
        aut0 = (1.0 - e) * one_minus + e * non0
        non1 = 2.0 * freq * one_minus
        aut1 = e * non1
        non2 = freq * freq
        aut2 = (1.0 - e) * freq + e * non2
        r0 = np.log10(aut0 / non0)
        r1 = np.log10(aut1 / non1)
        r2 = np.log10(aut2 / non2)
    out = np.zeros(np.broadcast_shapes(geno.shape, r0.shape), dtype=np.float64)
    np.copyto(out, r0, where=(geno == 0))
    np.copyto(out, r1, where=(geno == 1))
    np.copyto(out, r2, where=(geno == 2))
    # monomorphic sites score 0 for every genotype (freq==0 or freq==1)
    mono = (freq == 0.0) | (freq == 1.0)
    out = np.where(mono, 0.0, out)
    return out.astype(dtype, copy=False)


_lod_table_cache = {}  # id(freq) -> (freq strong ref, error, table)


def lod_table(freq: np.ndarray, error: float) -> np.ndarray:
    """[4, L] float64 table of lod values for genotype classes 0,1,2,missing.

    Only valid for scalar error (no TGLS).  One shared pass computes all
    three class rows (lod_terms per class would evaluate the identical
    r0/r1/r2 expressions three times — ~150 ms per 500k-locus call at the
    1000x1M scale), and results cache per freq ARRAY identity: the
    chunked exact paths (tie repair, Phase-II exact sampling) rebuild
    subset chromosomes that share the parent's freq object, so the table
    is computed once per (chromosome, error).  The cached entry holds a
    strong reference to the freq array, so its id cannot be reused while
    the entry lives."""
    key = id(freq)
    hit = _lod_table_cache.get(key)
    if hit is not None and hit[0] is freq and hit[1] == error:
        return hit[2]
    L = freq.shape[0]
    p = np.asarray(freq, dtype=np.float64)
    e = np.float64(error)
    one_minus = 1.0 - p
    with np.errstate(divide="ignore", invalid="ignore"):
        non0 = one_minus * one_minus
        aut0 = (1.0 - e) * one_minus + e * non0
        non1 = 2.0 * p * one_minus
        aut1 = e * non1
        non2 = p * p
        aut2 = (1.0 - e) * p + e * non2
        r0 = np.log10(aut0 / non0)
        r1 = np.log10(aut1 / non1)
        r2 = np.log10(aut2 / non2)
    mono = (p == 0.0) | (p == 1.0)
    table = np.zeros((4, L), dtype=np.float64)
    table[0] = np.where(mono, 0.0, r0)
    table[1] = np.where(mono, 0.0, r1)
    table[2] = np.where(mono, 0.0, r2)
    if len(_lod_table_cache) >= 4:  # tiny LRU: panels have few chroms live
        _lod_table_cache.pop(next(iter(_lod_table_cache)))
    _lod_table_cache[key] = (freq, error, table)
    return table


# ---------------------------------------------------------------------------
# Gap / centromere masking (reference inGap + calcLOD skip logic,
# src/garlic-roh.cpp:11-16,55-123)
# ---------------------------------------------------------------------------

def in_gap(q_start, q_end, t_start, t_end):
    """inGap (src/garlic-roh.cpp:11-16): query interval touches target."""
    return (((t_start <= q_start) & (t_end >= q_start)) |
            ((t_start <= q_end) & (t_end >= q_end)) |
            ((t_start >= q_start) & (t_end <= q_end)))


def pair_breaks(positions: np.ndarray, max_gap: int, cstart: int,
                cend: int) -> np.ndarray:
    """bool [L]: breaks[i] = adjacent pair (i-1, i) violates the gap or
    centromere test. breaks[0] is False (no previous locus)."""
    pos = np.asarray(positions, dtype=np.int64)
    b = np.zeros(pos.shape[0], dtype=bool)
    if pos.shape[0] > 1:
        p0 = pos[:-1]
        p1 = pos[1:]
        b[1:] = (p1 - p0 > max_gap) | in_gap(p0, p1, cstart, cend)
    return b


def window_missing_mask(positions: np.ndarray, winsize: int, max_gap: int,
                        cstart: int, cend: int) -> np.ndarray:
    """bool [nwin]: True where window l (starting locus l) is MISSING.

    nwin = max(L - winsize + 1, 0).  Window l is missing iff its first locus
    is inside the centromere (the i==locus self-pair check,
    src/garlic-roh.cpp:58-61) or any pair break falls in (l, l+W-1]."""
    pos = np.asarray(positions, dtype=np.int64)
    L = pos.shape[0]
    nwin = L - winsize + 1
    if nwin <= 0:
        return np.zeros(0, dtype=bool)
    b = pair_breaks(pos, max_gap, cstart, cend)
    csum = np.concatenate([[0], np.cumsum(b.astype(np.int64))])
    # breaks in (l, l+W-1]  <=>  csum[l+W] - csum[l+1] > 0
    any_break = (csum[winsize:winsize + nwin] - csum[1:nwin + 1]) > 0
    first_in_centro = (pos[:nwin] >= cstart) & (pos[:nwin] <= cend)
    return any_break | first_in_centro


# ---------------------------------------------------------------------------
# Exact engine (float64, reference summation order)
# ---------------------------------------------------------------------------

def lod_windows_exact(terms: np.ndarray, missing: np.ndarray,
                      winsize: int) -> np.ndarray:
    """win [I, L] float64 (MISSING-padded) from per-locus terms [I, L].

    Reproduces the rolling-sum order of calcLOD (src/garlic-roh.cpp:46-126):
    the first window of each non-missing run is a fresh left-to-right sum;
    subsequent windows are (prev - head) + tail."""
    try:
        from ..native import lod_windows_exact_native
        return lod_windows_exact_native(terms, missing, winsize)
    except Exception:
        return _lod_windows_exact_numpy(terms, missing, winsize)


def _lod_windows_exact_numpy(terms: np.ndarray, missing: np.ndarray,
                             winsize: int) -> np.ndarray:
    I, L = terms.shape
    win = np.full((I, L), float(MISSING), dtype=np.float64)
    nwin = L - winsize + 1
    if nwin <= 0:
        return win
    a = terms
    l = 0
    acc = None
    while l < nwin:
        if missing[l]:
            l += 1
            acc = None
            continue
        if acc is None:
            # fresh left-to-right sum (src/garlic-roh.cpp:55-75)
            acc = np.zeros(I, dtype=np.float64)
            for k in range(winsize):
                acc = acc + a[:, l + k]
        else:
            # rolling update (src/garlic-roh.cpp:91-101): (prev - head) + tail
            acc = (acc - a[:, l - 1]) + a[:, l + winsize - 1]
        win[:, l] = acc
        if l + 1 < nwin and missing[l + 1]:
            acc = None
        l += 1
    return win


# ---------------------------------------------------------------------------
# Fast engine (float32 JAX)
# ---------------------------------------------------------------------------

def window_sums_exact(a, winsize: int):
    """VALID sliding-window sums along the last axis ([.., L] -> [.., L-W+1])
    by shifted-add doubling: width-2k sums from two width-k sums, then the
    binary decomposition of W.  O(log W) passes of TRUE elementwise adds in
    the input dtype — no convolution or matrix product, whose lowering may
    accumulate in reduced precision.  Exact for f32 integer data < 2^24,
    and pairwise-tree accuracy (better than sequential) for reals."""
    L = a.shape[-1]
    nwin = L - winsize + 1
    sums = {1: a}
    k = 1
    while k * 2 <= winsize:
        s = sums[k]
        sums[2 * k] = s[..., : s.shape[-1] - k] + s[..., k:]
        k *= 2
    out = None
    off = 0
    for k in sorted(sums, reverse=True):
        if winsize & k:
            part = sums[k][..., off:off + nwin]
            out = part if out is None else out + part
            off += k
    return out


def table_terms(g, table):
    """f32 per-(ind, locus) LOD terms from genotype codes g (0/1/2; any
    other value is missing and scores 0) and a per-locus class table
    (rows 0-2): elementwise selects over broadcast rows, no gather."""
    import jax.numpy as jnp
    a = jnp.where(g == 0, table[0][None, :],
                  jnp.where(g == 1, table[1][None, :],
                            jnp.where(g == 2, table[2][None, :], 0.0)))
    return a.astype(jnp.float32)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def lod_windows_fast_jax(geno, table, missing, winsize: int):
    """JAX fast path: win [I, L] float32 with MISSING padding.

    geno:    [I, L] int8 (-9 missing)
    table:   [>=3, L] float32 lod terms per genotype class
    missing: [nwin] bool window mask
    """
    import jax.numpy as jnp
    I, L = geno.shape
    s = window_sums_exact(table_terms(geno.astype(jnp.int32), table),
                          winsize)
    s = jnp.where(missing[None, :], jnp.float32(MISSING), s)
    pad = jnp.full((I, winsize - 1), jnp.float32(MISSING))
    return jnp.concatenate([s, pad], axis=1)


@partial(__import__("jax").jit, static_argnames=("winsize",))
def lod_windows_fast_gl(geno, freq, gl, missing, winsize: int):
    """JAX fast path with per-genotype error (TGLS): computes lod terms
    elementwise on device (src/garlic-roh.cpp:68,91-95 — the TGLS value
    replaces epsilon), then window sums; [I, L] f32, MISSING tail."""
    import jax.numpy as jnp
    g = geno.astype(jnp.int32)
    p = freq.astype(jnp.float32)[None, :]
    e = gl.astype(jnp.float32)
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
    a = jnp.where(g == 0, r0, jnp.where(g == 1, r1,
                  jnp.where(g == 2, r2, 0.0)))
    mono = (p == 0.0) | (p == 1.0)
    a = jnp.where(mono, 0.0, a)
    I, L = geno.shape
    s = window_sums_exact(a, winsize)
    s = jnp.where(missing[None, :], jnp.float32(MISSING), s)
    pad = jnp.full((I, winsize - 1), jnp.float32(MISSING))
    return jnp.concatenate([s, pad], axis=1)


# ---------------------------------------------------------------------------
# Engine dispatch
# ---------------------------------------------------------------------------

def calc_lod_windows(chrom, centro, winsize: int, error: float,
                     max_gap: int, use_gl: bool,
                     engine: str = "exact", bar=None) -> np.ndarray:
    """Full Phase-I window matrix [I, L] for one chromosome.

    Mirrors calcLOD/calcLODWindows (src/garlic-roh.cpp:18-132,279-309).
    engine: "exact" (f64 reference order) | "fast" (f32 JAX path).
    bar: optional core.pbar.Bar advanced as individuals complete (the
    reference ticks once per individual, src/garlic-roh.cpp:48)."""
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    nwin = max(chrom.nloci - winsize + 1, 0)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    if engine == "fast":
        import jax.numpy as jnp
        if nwin == 0:
            return np.full((chrom.nind, chrom.nloci), float(MISSING))
        if use_gl:
            win = lod_windows_fast_gl(jnp.asarray(chrom.genotypes),
                                      jnp.asarray(chrom.freq),
                                      jnp.asarray(chrom.gl),
                                      jnp.asarray(missing), winsize)
        else:
            table = lod_table(chrom.freq, error).astype(np.float32)
            win = lod_windows_fast_jax(jnp.asarray(chrom.genotypes),
                                       jnp.asarray(table),
                                       jnp.asarray(missing), winsize)
        return np.asarray(win, dtype=np.float64)
    if not use_gl:
        # table-driven native kernel: same per-(genotype, locus) f64
        # values, no [I, L] terms materialization
        try:
            from ..native import lod_windows_exact_tbl_native
            table = lod_table(chrom.freq, error)
            I = chrom.genotypes.shape[0]
            if bar is None or I <= 1:
                win = lod_windows_exact_tbl_native(chrom.genotypes, table,
                                                   missing, winsize)
                if win is not None:
                    return win
            else:
                # tick as individuals complete: chunk the kernel over
                # individual blocks (rows are independent; OpenMP still
                # fans out within each block)
                step = max(1, -(-I // 8))
                outs = []
                for s in range(0, I, step):
                    w = lod_windows_exact_tbl_native(
                        chrom.genotypes[s:s + step], table, missing, winsize)
                    if w is None:
                        outs = None
                        break
                    outs.append(w)
                    bar.advance(min(step, I - s))
                if outs is not None:
                    return np.concatenate(outs, axis=0)
        except ImportError:
            pass
    err = chrom.gl if use_gl else error
    terms = lod_terms(chrom.genotypes, chrom.freq, err)
    win = lod_windows_exact(terms, missing, winsize)
    if bar is not None:
        bar.advance(chrom.genotypes.shape[0])
    return win
