"""Device (fast-engine) weighted path vs the f64 numpy reference engine."""

from __future__ import annotations

import numpy as np
import pytest

from garlic_tpu.core.types import ChromData, MISSING
from garlic_tpu.ops import device_wlod, ld as ld_ops, wlod as wlod_ops


class _Centro:
    def __init__(self, s=10**9, e=10**9 + 1):
        self._s, self._e = s, e

    def start(self, c):
        return self._s

    def end(self, c):
        return self._e


def _chrom(I=18, L=300, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    g[rng.random((I, L)) < 0.04] = -9
    pos = np.cumsum(rng.integers(200, 4000, L)).astype(np.int64)
    gpos = np.cumsum(rng.random(L) * 0.01)
    freq = np.clip(rng.beta(1, 1, L), 0.05, 0.95)
    fc = rng.random((I, L)) < 0.5
    return ChromData(chrom="chr1", positions=pos, gpos=gpos,
                     locus_names=[f"r{i}" for i in range(L)],
                     alleles=np.array(["A"] * L), genotypes=g, freq=freq,
                     first_copy=fc)


@pytest.mark.parametrize("phased", [False, True])
def test_ld_band_device_matches_numpy(phased):
    c = _chrom(seed=1)
    W = 12
    ref = ld_ops.calc_ld(c, W, phased, None, engine="fast")
    got = np.asarray(device_wlod.ld_band_device(c, W, phased, None))
    nwin = c.nloci - W + 1
    np.testing.assert_allclose(got[:nwin], ref[:nwin], rtol=2e-4, atol=2e-4)


def test_ld_band_device_subsample():
    c = _chrom(I=24, seed=2)
    W = 8
    sub = np.arange(10)
    ref = ld_ops.calc_ld(c, W, False, sub, engine="fast")
    got = np.asarray(device_wlod.ld_band_device(c, W, False, sub))
    nwin = c.nloci - W + 1
    np.testing.assert_allclose(got[:nwin], ref[:nwin], rtol=2e-4, atol=2e-4)


def test_wlod_windows_device_matches_numpy():
    c = _chrom(seed=3)
    W = 10
    centro = _Centro()
    ld = ld_ops.calc_ld(c, W, False, None, engine="exact")
    ref = wlod_ops.wlod_windows(c, centro, ld, W, 0.001, 200000, False,
                                1e-9, 7)
    ld_dev = device_wlod.ld_band_device(c, W, False, None)
    got_dw = device_wlod.wlod_windows_device(c, centro, ld_dev, W, 0.001,
                                             200000, False, 1e-9, 7)
    got = got_dw.to_numpy()
    np.testing.assert_array_equal(got == MISSING, ref == MISSING)
    live = ref != MISSING
    np.testing.assert_allclose(got[live], ref[live], rtol=3e-3, atol=3e-3)


def test_wlod_windows_device_centromere_mask():
    c = _chrom(seed=4)
    W = 10
    centro = _Centro(int(c.positions[100]), int(c.positions[140]))
    ld_dev = device_wlod.ld_band_device(c, W, False, None)
    got = device_wlod.wlod_windows_device(c, centro, ld_dev, W, 0.001,
                                          200000, False, 1e-9, 7).to_numpy()
    ld = ld_ops.calc_ld(c, W, False, None, engine="exact")
    ref = wlod_ops.wlod_windows(c, centro, ld, W, 0.001, 200000, False,
                                1e-9, 7)
    np.testing.assert_array_equal(got == MISSING, ref == MISSING)


@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("subsample", [False, True])
def test_fused_weighted_matches_two_step(phased, subsample):
    """weighted_windows_device (ONE fused dispatch) must reproduce the
    two-step ld_band_device + wlod_windows_device chain it replaces.
    Tolerance covers the one real numeric difference: the fused path
    computes full-panel hom freqs on device in f32 (counts are exact
    ints, only the final division rounds) vs the host f64 path."""
    c = _chrom(I=20, L=290, seed=7 + phased)
    W = 11
    centro = _Centro(int(c.positions[60]), int(c.positions[80]))
    sub = np.arange(2, 16) if subsample else None
    ld_dev = device_wlod.ld_band_device(c, W, phased, sub)
    ref = device_wlod.wlod_windows_device(
        c, centro, ld_dev, W, 0.001, 200000, False, 1e-9, 7).to_numpy()
    got = device_wlod.weighted_windows_device(
        c, centro, W, 0.001, 200000, False, 1e-9, 7, phased,
        sub).to_numpy()
    np.testing.assert_array_equal(got == MISSING, ref == MISSING)
    live = ref != MISSING
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-5, atol=1e-5)


def test_wlod_table_gather_bitwise_equals_score_ship():
    """The device table-gather score path (2-bit geno + [4, L] class
    table) must reproduce the old [I, L] f32 score ship BIT-FOR-BIT:
    both are f32 casts of the same f64 (lod*nomut)*norec products, so
    any difference is a table/gather bug, not rounding."""
    import jax.numpy as jnp

    from garlic_tpu.ops.device_cache import _packed_2bit

    for seed in range(4):
        c = _chrom(I=11, L=257 + 13 * seed, seed=seed)
        I, L = c.genotypes.shape
        L2 = -(-L // 128) * 128
        old = wlod_ops.wlod_scores(c, 0.001, False, 1e-9, 7).astype(
            np.float32)
        tp = np.zeros((4, L2), dtype=np.float32)
        from garlic_tpu.ops.lod import lod_table
        nomut, norec = device_wlod._decay_factors(c, 1e-9, 7)
        tp[:, :L] = ((lod_table(c.freq, 0.001) * nomut[None, :])
                     * norec[None, :]).astype(np.float32)
        got = np.asarray(device_wlod._wlod_score_from_table(
            jnp.asarray(_packed_2bit(c)), jnp.asarray(tp),
            I, L, L2))
        np.testing.assert_array_equal(got[:, :L], old)
        assert np.all(got[:, L:] == 0.0)


@pytest.mark.parametrize("phased", [False, True])
def test_weighted_chunked_bit_identical(phased, monkeypatch):
    """A tiny HBM budget routes weighted Phase I through the chunked
    path (LD band from chunk-accumulated pair counts + per-individual-
    chunk score/window dispatches); every value must be bit-identical
    to the fused single-dispatch program (counts are exact integers in
    f32 and the chunk rows replay the same expression sequence)."""
    c = _chrom(I=30, L=400, seed=9)
    centro = _Centro()
    W = 14
    fused = device_wlod.weighted_windows_device(
        c, centro, W, 0.001, 200000, False, 1e-9, 7, phased, None)
    a = fused.to_numpy()
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "2e6")
    chunked = device_wlod.weighted_windows_device(
        c, centro, W, 0.001, 200000, False, 1e-9, 7, phased, None)
    b = chunked.to_numpy()
    np.testing.assert_array_equal(a, b)


def test_weighted_chunked_subsample_bit_identical(monkeypatch):
    """Chunked path with an LD subsample (the production shape for
    1000+-individual --weighted --ld-subsample runs)."""
    c = _chrom(I=26, L=350, seed=11)
    centro = _Centro()
    W = 10
    sub = np.array([1, 4, 5, 9, 12, 20, 25], dtype=np.int64)
    fused = device_wlod.weighted_windows_device(
        c, centro, W, 0.001, 200000, False, 1e-9, 7, False, sub)
    a = fused.to_numpy()
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "2e6")
    chunked = device_wlod.weighted_windows_device(
        c, centro, W, 0.001, 200000, False, 1e-9, 7, False, sub)
    b = chunked.to_numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("phased", [False, True])
def test_ld_band_chunked_bit_identical(phased, monkeypatch):
    c = _chrom(I=22, L=320, seed=13)
    W = 9
    a = np.asarray(device_wlod.ld_band_device(c, W, phased, None))
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "2e6")
    b = np.asarray(device_wlod.ld_band_device(c, W, phased, None))
    np.testing.assert_array_equal(a, b)
