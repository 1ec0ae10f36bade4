"""Fast-engine Phase I on the CPU backend: the XLA window programs against
the f64 exact engine, and the bucketed device layout."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from garlic_tpu.centromeres import Centromere
from garlic_tpu.core.types import MISSING, ChromData
from garlic_tpu.logger import RunLog
from garlic_tpu.ops import device_win, lod as lod_ops
from garlic_tpu.ops.device_cache import clear_device_cache, pack_genotypes

EPS32 = 2.0 ** -23


def _case(I, L, W, seed=0):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.03] = -9
    freq = np.clip(rng.beta(1, 1, L), 0.02, 0.98)
    pos = np.cumsum(rng.integers(100, 4000, L)).astype(np.int64)
    miss = lod_ops.window_missing_mask(pos, W, 100000, pos[L // 3],
                                       pos[min(L // 3 + 20, L - 1)])
    return geno, freq, pos, miss


def _chrom(geno, freq, pos, gl=None):
    L = geno.shape[1]
    return ChromData(chrom="chr1", positions=pos, gpos=np.zeros(L),
                     locus_names=[f"rs{i}" for i in range(L)],
                     alleles=np.array(["A"] * L), genotypes=geno, freq=freq,
                     gl=gl)


def _band(freq, error, W):
    """The tie patrol's suspect half-width for this panel (pipeline
    _tie_band: 256 eps32 W tmax)."""
    from garlic_tpu.pipeline import _corner_tmax_compute
    c = _chrom(np.zeros((1, freq.shape[0]), np.int8), freq,
               np.arange(freq.shape[0]))
    return 256.0 * EPS32 * W * _corner_tmax_compute(c, error, False)


def _assert_within_band(got, ref, band):
    np.testing.assert_array_equal(got == MISSING, ref == MISSING)
    live = ref != MISSING
    assert np.max(np.abs(got[live] - ref[live]), initial=0.0) <= band


@pytest.mark.parametrize("I,L,W", [
    (5, 1000, 17),     # unaligned everything
    (32, 2048, 60),
    (7, 700, 60),      # fewer windows than one block
    (3, 64, 33),       # tiny
    (7, 3000, 120),    # W > 64
    (4, 3000, 300),
])
def test_fast_windows_match_exact(I, L, W):
    """f32 XLA window sums stay inside the tie band of the f64 engine."""
    geno, freq, _, miss = _case(I, L, W)
    table = lod_ops.lod_table(freq, 0.001)
    got = np.asarray(lod_ops.lod_windows_fast_jax(
        jnp.asarray(geno), jnp.asarray(table.astype(np.float32)),
        jnp.asarray(miss), W))
    ref = lod_ops.lod_windows_exact(lod_ops.lod_terms(geno, freq, 0.001),
                                    miss, W)
    _assert_within_band(got, ref, _band(freq, 0.001, W))


@pytest.mark.parametrize("I,L,W", [(7, 900, 19), (5, 2000, 100)])
def test_fast_gl_windows_match_exact(I, L, W):
    """TGLS: f32 log10 terms on device, same band as the plain path."""
    geno, freq, _, miss = _case(I, L, W, seed=3)
    rng = np.random.default_rng(3)
    gl = 10.0 ** (-rng.integers(5, 60, (I, L)) / 10.0)
    got = np.asarray(lod_ops.lod_windows_fast_gl(
        jnp.asarray(geno), jnp.asarray(freq), jnp.asarray(gl),
        jnp.asarray(miss), W))
    ref = lod_ops.lod_windows_exact(lod_ops.lod_terms(geno, freq, gl),
                                    miss, W)
    from garlic_tpu.pipeline import _corner_tmax_compute
    tmax = _corner_tmax_compute(_chrom(geno, freq, np.arange(L), gl=gl),
                                0.001, True)
    _assert_within_band(got, ref, 256.0 * EPS32 * W * tmax)


@pytest.mark.parametrize("W", [17, 60, 300])
def test_bucketed_windows_equal_unbucketed(W):
    """The bucketed device program (2-bit payload, padded rows/columns)
    computes every live window exactly as the [I, L] program does: the
    shifted-add tree of each window is the same, padding never leaks."""
    geno, freq, pos, _ = _case(9, 1700, W, seed=5)
    centro = Centromere("hg18", "none", "none", RunLog())
    clear_device_cache()
    dw = device_win.lod_windows_device(_chrom(geno, freq, pos), centro, W,
                                       0.001, 100000, False)
    NW2, _ = device_win.phase1_layout(1700, W)
    assert dw.win.shape == (9, NW2) and dw.nwin == 1700 - W + 1
    miss = lod_ops.window_missing_mask(pos, W, 100000, centro.start("chr1"),
                                       centro.end("chr1"))
    table = lod_ops.lod_table(freq, 0.001).astype(np.float32)
    ref = np.asarray(lod_ops.lod_windows_fast_jax(
        jnp.asarray(geno), jnp.asarray(table), jnp.asarray(miss), W))
    np.testing.assert_array_equal(dw.to_numpy(), ref.astype(np.float64))
    assert (np.asarray(dw.win)[:, dw.nwin:] == MISSING).all()


def test_degenerate_no_windows():
    """nwin <= 0: every window slot is MISSING on both fast entries."""
    geno, freq, pos, _ = _case(4, 10, 20)
    centro = Centromere("hg18", "none", "none", RunLog())
    c = _chrom(geno, freq, pos)
    dw = device_win.lod_windows_device(c, centro, 20, 0.001, 100000, False)
    assert dw.to_numpy().shape == (4, 10)
    assert (dw.to_numpy() == MISSING).all()
    win = lod_ops.calc_lod_windows(c, centro, 20, 0.001, 100000, False,
                                   engine="fast")
    assert win.shape == (4, 10) and (win == MISSING).all()


def test_padding_is_inert():
    """Bucket padding rows must not leak into real rows."""
    geno, freq, pos, _ = _case(5, 300, 30, seed=7)
    centro = Centromere("hg18", "none", "none", RunLog())
    a = device_win.lod_windows_device(_chrom(geno, freq, pos), centro, 30,
                                      0.001, 100000, False).to_numpy()
    b = device_win.lod_windows_device(_chrom(np.vstack([geno, geno]), freq,
                                             pos), centro, 30, 0.001,
                                      100000, False).to_numpy()
    np.testing.assert_array_equal(a, b[:5])
    np.testing.assert_array_equal(a, b[5:])


@pytest.mark.parametrize("L,W", [(5000, 60), (500_000, 60), (9000, 300),
                                 (8193, 1)])
def test_phase1_layout(L, W):
    NW2, L2 = device_win.phase1_layout(L, W)
    nwin = L - W + 1
    assert NW2 >= max(nwin, 8192) and NW2 & (NW2 - 1) == 0
    assert NW2 < 2 * max(nwin, 8192)
    assert L2 - NW2 >= W - 1 and L2 % 4 == 0 and L2 >= L


def test_single_phase1_compile_across_lengths():
    """Chromosomes of different lengths in one bucket share ONE compiled
    Phase-I program; only the cheap per-shape 2-bit repad recompiles."""
    centro = Centromere("hg18", "none", "none", RunLog())
    before = device_win._packed_windows._cache_size()
    for L in (900, 700, 800):
        geno, freq, pos, _ = _case(5, L, 21, seed=L)
        device_win.lod_windows_device(_chrom(geno, freq, pos), centro, 21,
                                      0.001, 100000, False)
    assert device_win._packed_windows._cache_size() - before == 1


def test_pack_genotypes_roundtrip():
    rng = np.random.default_rng(2)
    g = rng.integers(0, 3, size=(5, 64)).astype(np.int8)
    g[rng.random((5, 64)) < 0.2] = -9
    p = pack_genotypes(g)
    assert p.shape == (5, 16)
    codes = np.stack([(p >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(5, 64)
    back = np.where(codes == 3, -9, codes).astype(np.int8)
    np.testing.assert_array_equal(back, g)


def test_packed_filter_pipeline_stays_packed(tmp_path):
    """Cache-hit loads stay in 2-bit form through monomorphic filtering:
    the int8 matrix is never materialized on that path."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from util import make_panel, write_tped

    from garlic_tpu.io import filters, tped

    panel = make_panel(nind=10, nloci_per_chr=(800,), seed=91)
    write_tped(panel, str(tmp_path / "p.tped.gz"), str(tmp_path / "p.tfam"))
    rng = np.random.default_rng(0)
    tped.load_tped(str(tmp_path / "p.tped.gz"), "0", 0, False, True,
                   RunLog(), rng, panel_cache=True)
    ds, _ = tped.load_tped(str(tmp_path / "p.tped.gz"), "0", 0, False, True,
                           RunLog(), rng, panel_cache=True)
    assert ds.chroms[0].geno_is_packed_only
    chroms, _ = filters.filter_monomorphic(ds.chroms)
    c = chroms[0]
    assert c.geno_is_packed_only, "filtering materialized the int8 matrix"
    # lazy materialization agrees with a from-scratch parse + filter
    ds2, _ = tped.load_tped(str(tmp_path / "p.tped.gz"), "0", 0, False,
                            True, RunLog(), rng, panel_cache=False)
    chroms2, _ = filters.filter_monomorphic(ds2.chroms)
    np.testing.assert_array_equal(c.genotypes, chroms2[0].genotypes)
