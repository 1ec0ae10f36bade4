"""Round-2 hardening tests: --threads plumbing, one-compile device KDE,
long-locus-name freq writing (the snprintf OOB fix), and bar behavior."""

import gzip
import io
import os
import tempfile

import numpy as np
import pytest

from garlic_tpu.native import (get_native_max_threads, native_available,
                               set_native_threads, write_freq_chrom_native)


@pytest.mark.skipif(not native_available(), reason="native lib unavailable")
def test_set_native_threads():
    """--threads N must actually cap the OpenMP fan-out (the reference
    spawns exactly N workers, src/garlic-roh.cpp:184-194)."""
    old = get_native_max_threads()
    try:
        set_native_threads(2)
        assert get_native_max_threads() == 2
        set_native_threads(1)
        assert get_native_max_threads() == 1
        set_native_threads(0)  # no-op
        assert get_native_max_threads() == 1
    finally:
        set_native_threads(old)


@pytest.mark.skipif(not native_available(), reason="native lib unavailable")
def test_freq_write_long_locus_names(tmp_path):
    """Locus names longer than any fixed stack buffer must round-trip
    uncorrupted through the native gz freq writer."""
    names = ["rs1", "x" * 300, "rs3"]
    pos = np.array([100, 200, 300], dtype=np.int64)
    alleles = np.array(["A", "C", "G"])
    freq = np.array([0.25, 0.5, 0.125])
    path = str(tmp_path / "long.freq.gz")
    assert write_freq_chrom_native(path, False, "chr1", names, pos,
                                   alleles, freq)
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    assert lines[0] == "CHR\tSNP\tPOS\tALLELE\tFREQ"
    assert lines[1] == "chr1\trs1\t100\tA\t0.25"
    assert lines[2] == "chr1\t" + "x" * 300 + "\t200\tC\t0.5"
    assert lines[3] == "chr1\trs3\t300\tG\t0.125"


def test_device_kde_single_compile():
    """gauss_transform(device=True) must not recompile per bandwidth:
    a 5-iteration winsize search calls it with a fresh h (and a fresh
    sample count) each time (VERDICT round 1, weak #3)."""
    from garlic_tpu.ops import kde

    rng = np.random.default_rng(0)
    tgt = np.linspace(-1.0, 3.0, 512)
    # other tests in the same process share this jit cache (the exact
    # Phase-II sampler routes fast-engine KDEs through it too), so assert
    # on GROWTH, not absolute size
    before = kde._device_gauss_block()._cache_size()
    for i, (n, h) in enumerate([(1000, 0.1), (1500, 0.2), (2000, 0.15),
                                (3000, 0.3), (2500, 0.12)]):
        src = rng.standard_normal(n)
        got = kde.gauss_transform(src, tgt, h, device=True)
        want = kde.gauss_transform(src, tgt, h, device=False)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)
    block = kde._device_gauss_block()
    # power-of-two bucketing: 1000/1500 -> 1024/2048, 2000/2500/3000 -> 2048/4096
    assert block._cache_size() - before <= 3


def test_pbar_ticks_and_output():
    """The bar replicates the reference's display: unweighted total=nloci
    advanced per individual shows ' 0%' then '100%' (garlic-pbar.cpp:6-34,
    garlic-roh.cpp:40,48); a total=nind bar ticks through percentages."""
    from garlic_tpu.core.pbar import Bar

    buf = io.StringIO()
    bar = Bar(total=577489, stream=buf)
    for _ in range(45):
        bar.advance(1)
    bar.finalize()
    assert buf.getvalue() == "\b\b\b 0%\b\b\b100%\n"

    buf2 = io.StringIO()
    bar2 = Bar(total=100, stream=buf2)
    for _ in range(100):
        bar2.advance(1)
    bar2.finalize()
    assert "50%" in buf2.getvalue()


def test_covered_edges_equivalent(monkeypatch):
    """The run-edge coverage transfer (GARLIC_TPU_COVERED=edges, the
    slow-link strategy) must produce byte-identical packed bits to the
    bitmap path, including the cap fallback."""
    monkeypatch.setenv("GARLIC_TPU_COVERED", "edges")
    import jax.numpy as jnp

    from garlic_tpu.ops import device_win
    from garlic_tpu.ops.device_win import (DeviceWin,
                                           _covered_kernel_factory,
                                           covered_packed)

    cov = _covered_kernel_factory()
    for seed, cutoff in [(0, -0.5), (1, 0.8), (2, 3.0)]:
        rng = np.random.default_rng(seed)
        I, N, W = 9, 500, 12
        win = rng.standard_normal((I, N)).astype(np.float32) * 2
        win[rng.random((I, N)) < 0.1] = -9999.0
        dw = DeviceWin(win=jnp.asarray(win), nind=I, nloci=N)
        got, sus, _ = covered_packed(dw, cutoff, W, 3.0)
        want = np.asarray(cov(jnp.asarray(win), jnp.float32(cutoff),
                              jnp.float32(3.0), jnp.float32(0.0),
                              W))[:, :-1]
        np.testing.assert_array_equal(got, want)
        assert not sus.any()
    # tier escalation: tier-1 overflow retries at the final edge tier
    monkeypatch.setattr(device_win, "_EDGE_T1_CAP", 4)
    monkeypatch.setattr(device_win, "_EDGE_T1_IDX_CAP", 4)
    rng = np.random.default_rng(3)
    win = rng.standard_normal((9, 500)).astype(np.float32) * 2
    dw = DeviceWin(win=jnp.asarray(win), nind=9, nloci=500)
    got, _, _ = covered_packed(dw, 0.0, 12, 3.0)
    want = np.asarray(cov(jnp.asarray(win), jnp.float32(0.0),
                          jnp.float32(3.0), jnp.float32(0.0), 12))[:, :-1]
    np.testing.assert_array_equal(got, want)
    # bitmap fallback: every edge tier overflows
    monkeypatch.setattr(device_win, "_EDGE_CAP", 4)
    monkeypatch.setattr(device_win, "_EDGE_IDX_CAP", 4)
    got, _, _ = covered_packed(dw, 0.0, 12, 3.0)
    np.testing.assert_array_equal(got, want)


def test_unpack_2bit_roundtrip():
    """Native 2-bit unpack (panel-cache load path) inverts pack exactly."""
    from garlic_tpu.native import native_available, unpack_2bit_native
    from garlic_tpu.ops.device_cache import pack_genotypes

    if not native_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(5)
    for I, L in [(7, 101), (20, 4000), (3, 4)]:
        Lp = -(-L // 4) * 4
        g = rng.integers(0, 3, size=(I, Lp)).astype(np.int8)
        g[rng.random((I, Lp)) < 0.1] = -9
        u = unpack_2bit_native(pack_genotypes(g), L)
        np.testing.assert_array_equal(u, g[:, :L])


@pytest.mark.parametrize("seed", range(3))
def test_2bit_ship_roundtrip(seed):
    """_decode_2bit (raw-byte ship + device repad) must reproduce the
    exact 2-bit Phase-I input gt_repad_2bit produces, including ragged
    last-byte tails."""
    import jax.numpy as jnp

    from garlic_tpu.native import native_available, repad_2bit_native
    from garlic_tpu.ops.device_cache import _decode_2bit, pack_genotypes

    if not native_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(100 + seed)
    I = int(rng.integers(1, 40))
    L = int(rng.integers(5, 3000))
    g = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    g[rng.random((I, L)) < 0.03] = -9
    Lp = -(-L // 4) * 4
    gp = np.full((I, Lp), -9, np.int8)
    gp[:, :L] = g
    packed = pack_genotypes(gp)
    L2 = (-(-(L + 200) // 128)) * 128
    want = repad_2bit_native(packed, I, L2 // 4)
    got = np.asarray(_decode_2bit(jnp.asarray(packed), L, L2))
    np.testing.assert_array_equal(got, want)


def _packed_chrom(packed, L, freq, digest=None):
    from garlic_tpu.core.types import ChromData
    return ChromData(chrom="chr1",
                     positions=np.arange(1, L + 1, dtype=np.int64) * 1000,
                     gpos=np.zeros(L), locus_names=[f"rs{i}" for i in range(L)],
                     alleles=np.array(["A"] * L), genotypes=None,
                     geno2b=packed, freq=freq, geno2b_digest=digest)


def test_device_panel_cache_hit_and_eviction():
    """The device-resident panel cache returns identical Phase-I windows
    on a repeat run (content-addressed, no re-upload), never aliases
    distinct panels, and evicts LRU entries to stay under its budget."""
    from garlic_tpu.centromeres import Centromere
    from garlic_tpu.logger import RunLog
    from garlic_tpu.native import native_available
    from garlic_tpu.ops import device_cache as dc
    from garlic_tpu.ops.device_win import lod_windows_device

    if not native_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(9)
    I, L = 9, 1777
    Lp = -(-L // 4) * 4
    centro = Centromere("hg18", "none", "none", RunLog())

    def mk_panel(seed):
        r = np.random.default_rng(seed)
        g = r.integers(0, 3, size=(I, L)).astype(np.int8)
        gp = np.full((I, Lp), -9, np.int8)
        gp[:, :L] = g
        return dc.pack_genotypes(gp)

    freq = rng.uniform(0.05, 0.95, L)

    def windows(packed, W=60):
        return lod_windows_device(_packed_chrom(packed, L, freq), centro, W,
                                  0.001, 10**9, False)

    packed = mk_panel(1)
    dc.clear_device_cache()
    try:
        w1 = windows(packed)
        assert len(dc._device_cache) == 1
        h0 = dc._device_cache_hits
        w2 = windows(packed)
        assert dc._device_cache_hits == h0 + 1, "repeat run missed the cache"
        np.testing.assert_array_equal(np.asarray(w1.win), np.asarray(w2.win))
        # winsize-independence: a different winsize still reuses the payload
        windows(packed, W=100)
        assert dc._device_cache_hits == h0 + 2
        # a distinct panel of identical shape must NOT alias
        windows(mk_panel(2))
        assert dc._device_cache_hits == h0 + 2 and len(dc._device_cache) == 2
        # LRU eviction: with a ~one-entry budget, inserting a third panel
        # evicts the least-recently-used one and stays under budget
        one = dc._entry_nbytes(next(iter(dc._device_cache.values())))
        os.environ["GARLIC_TPU_DEVICE_CACHE"] = str((2 * one - 1) / (1 << 20))
        windows(mk_panel(3))
        assert len(dc._device_cache) == 1
        assert dc._device_cache_bytes <= 2 * one - 1
    finally:
        os.environ.pop("GARLIC_TPU_DEVICE_CACHE", None)
        dc.clear_device_cache()


def test_derived_digest_cache_key():
    """The sidecar-derived content key (core/digest.py) must let a
    device-cache hit serve a filtered chromosome WITHOUT materializing the
    filtered bytes: the monomorphic filter defers the packed compaction to
    a thunk, and _chrom_key (derived from the parent digest + keep mask)
    finds the payload uploaded under the same key earlier in the process."""
    from garlic_tpu.core.digest import (content_digest, derived_digest,
                                        ship_key_from_digest)
    from garlic_tpu.core.types import ChromData, LocusNames
    from garlic_tpu.io.filters import _apply
    from garlic_tpu.ops import device_cache as dc

    if not native_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(17)
    I, L = 7, 913
    Lp = -(-L // 4) * 4
    g = rng.integers(0, 3, size=(I, Lp)).astype(np.int8)
    g[:, L:] = -9
    packed = dc.pack_genotypes(np.ascontiguousarray(g))
    freq = rng.uniform(0.05, 0.95, L)
    freq[rng.choice(L, 40, replace=False)] = 0.0  # monomorphic → filtered
    keep = (freq > 0) & (freq < 1)
    dig = content_digest(packed)
    names = LocusNames([f"rs{i}" for i in range(L)])
    c = ChromData(chrom="chr1", positions=np.arange(1, L + 1, dtype=np.int64),
                  gpos=np.zeros(L), locus_names=names,
                  alleles=np.array(["A"] * L, dtype="<U1"), genotypes=None,
                  geno2b=packed, freq=freq, geno2b_digest=dig)

    fc = _apply(c, keep)
    nk = int(keep.sum())
    # the filter deferred the compaction and derived the child digest
    assert fc._geno2b is None and fc._geno2b_thunk is not None
    assert fc.nind == I and fc.nloci == nk
    assert fc.geno2b_digest == derived_digest(dig, keep)
    key = dc._chrom_key(fc)
    assert key == ship_key_from_digest(I, nk, fc.geno2b_digest)
    # determinism + sensitivity of the derivation
    assert derived_digest(dig, keep) == derived_digest(dig, keep.copy())
    keep2 = keep.copy()
    keep2[np.flatnonzero(keep)[0]] = False
    assert derived_digest(dig, keep2) != derived_digest(dig, keep)
    assert derived_digest(None, keep) is None

    dc.clear_device_cache()
    try:
        d1, k1 = dc.device_packed_keyed(fc)
        assert k1 == key and len(dc._device_cache) == 1

        # repeat with a poisoned thunk: a genuine hit never materializes
        def boom():
            raise AssertionError("cache hit materialized the payload")

        poisoned = _apply(c, keep)
        poisoned._geno2b_thunk = boom
        d2, k2 = dc.device_packed_keyed(poisoned)
        assert k2 == key and d2 is d1
        # and the derived-key payload equals the real filtered bytes
        np.testing.assert_array_equal(np.asarray(d1), fc.geno2b)
        assert dc._ship_key(fc.geno2b, nk)[:2] == key[:2]
    finally:
        dc.clear_device_cache()


def test_device_plane_cache():
    """_device_plane keeps small input planes (freq row, missing mask)
    device-resident keyed by content: same bytes -> same device buffer,
    different bytes -> different buffer; values always round-trip; the
    plane LRU stays within its budget and never touches the genotype
    cache."""
    from garlic_tpu.ops import device_cache as dc

    dc.clear_device_cache()
    try:
        a = np.arange(512, dtype=np.float32)
        d1 = dc._device_plane(a)
        d2 = dc._device_plane(a.copy())          # same content
        assert d1 is d2, "identical content must hit the plane cache"
        np.testing.assert_array_equal(np.asarray(d1), a)
        b = a + 1
        d3 = dc._device_plane(b)
        assert d3 is not d1
        np.testing.assert_array_equal(np.asarray(d3), b)
        # same bytes, different dtype/shape must not alias
        d4 = dc._device_plane(a.view(np.int32))
        assert d4 is not d1
        assert not dc._device_cache, "planes must not enter the geno cache"
        assert dc._plane_cache_bytes <= min(
            dc._device_cache_budget() // 8, 64 << 20)
    finally:
        dc.clear_device_cache()


def test_panel_cache_alleles_zero_copy():
    """v3+ sidecars store alleles as raw UCS4 so warm loads view them
    zero-copy as '<U1' (the old S1 encoding cost ~45 ms/chromosome in
    bytes->unicode conversion per load)."""
    from garlic_tpu.io import panelcache

    with tempfile.TemporaryDirectory() as td:
        tped = os.path.join(td, "p.tped")
        with open(tped, "w") as f:
            f.write("stub\n")
        rng = np.random.default_rng(3)
        L, I = 97, 5
        chroms = [{
            "chrom": "chr1",
            "positions": np.arange(L, dtype=np.int64) * 100,
            "gpos": np.zeros(L),
            "alleles": rng.choice(list("ACGT"), L).astype("<U1"),
            "genotypes": rng.integers(0, 3, size=(I, L)).astype(np.int8),
            "freq": rng.uniform(0.1, 0.9, L),
            "names": [f"rs{i}" for i in range(L)],
        }]
        panelcache.save_cache(tped, chroms, I)
        out = panelcache.load_cache(tped, want_fc=False)
        assert out is not None
        al = out[0]["alleles"]
        assert al.dtype == np.dtype("<U1")
        np.testing.assert_array_equal(al, chroms[0]["alleles"])
        # zero-copy: the array must be a view into the mapped file
        assert not al.flags.owndata
