"""I/O layer tests: TPED parser (native vs Python fallback, edge cases),
freq file round-trip with allele flipping, centromere tables, TGLS
conversion, genetic-map interpolation."""

from __future__ import annotations

import gzip
import os

import numpy as np
import pytest

from garlic_tpu.centromeres import Centromere
from garlic_tpu.io import freqfile, genmap, tfam, tgls, tped
from garlic_tpu.logger import RunLog


def _write(path, text):
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


TPED_BASIC = """\
1 rs1 0 1000 A A A C C C 0 0
1 rs2 0 2000 G G G G G G G G
2 rs3 0 500 T C C C T T 0 T
"""


def _load(path, missing="0", native=True):
    env = {}
    if not native:
        env["GARLIC_TPU_NO_NATIVE"] = "1"
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        import garlic_tpu.native.build as nb
        saved = nb._lib, nb._tried
        if not native:
            nb._lib, nb._tried = None, True
        try:
            rng = np.random.default_rng(0)
            return tped.load_tped(path, missing, 0, False, True,
                                  RunLog(), rng)
        finally:
            nb._lib, nb._tried = saved
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_tped_parse_basic(tmp_path, gz, native):
    p = str(tmp_path / ("a.tped" + (".gz" if gz else "")))
    _write(p, TPED_BASIC)
    ds, n = _load(p, native=native)
    assert n == 3
    assert [c.chrom for c in ds.chroms] == ["chr1", "chr2"]
    c1, c2 = ds.chroms
    # rs1: '1' allele = A (first non-missing); genotypes AA AC CC 00
    np.testing.assert_array_equal(c1.genotypes[:, 0], [2, 1, 0, -9])
    # freq: 3 A of 6 observed alleles
    assert c1.freq[0] == pytest.approx(0.5)
    # rs2 monomorphic G: freq 1.0
    assert c1.freq[1] == pytest.approx(1.0)
    # rs3: '1' allele = T; genotypes TC CC TT 0T -> het=1, 0, 2, half-missing
    np.testing.assert_array_equal(c2.genotypes[:, 0], [1, 0, 2, -9])
    # half-missing still counts its observed allele: T count = 1+0+2+1 = 4/7
    assert c2.freq[0] == pytest.approx(4 / 7)
    assert list(c1.positions) == [1000, 2000]
    assert list(c1.locus_names) == ["rs1", "rs2"]
    assert c1.alleles[0] == ("A" if not native or True else b"A")


def test_tped_native_matches_python(tmp_path):
    rng = np.random.default_rng(7)
    lines = []
    for ci, chrom in enumerate(["1", "2", "X"]):
        for l in range(57):
            g = []
            for i in range(9):
                for a in rng.choice(["A", "C", "0"], size=2, p=[.45, .45, .1]):
                    g.append(a)
            lines.append(f"{chrom} rs{ci}_{l} 0 {1000 + l * 777} "
                        + " ".join(g))
    p = str(tmp_path / "r.tped.gz")
    _write(p, "\n".join(lines) + "\n")
    ds_n, n_n = _load(p, native=True)
    ds_p, n_p = _load(p, native=False)
    assert n_n == n_p
    for a, b in zip(ds_n.chroms, ds_p.chroms):
        assert a.chrom == b.chrom
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_allclose(a.freq, b.freq, rtol=0, atol=0)
        assert list(a.locus_names) == list(b.locus_names)
        np.testing.assert_array_equal(np.asarray(a.alleles),
                                      np.asarray(b.alleles))
        np.testing.assert_array_equal(np.asarray(a.first_copy),
                                      np.asarray(b.first_copy))


def test_tped_crlf_and_blank_lines(tmp_path):
    text = TPED_BASIC.replace("\n", "\r\n") + "\r\n\r\n"
    p = str(tmp_path / "crlf.tped")
    _write(p, text)
    ds, n = _load(p)
    assert n == 3
    np.testing.assert_array_equal(ds.chroms[0].genotypes[:, 0], [2, 1, 0, -9])


def test_tped_no_trailing_newline(tmp_path):
    p = str(tmp_path / "nonl.tped")
    _write(p, TPED_BASIC.rstrip("\n"))
    ds, n = _load(p)
    assert n == 3


def test_freq_write_read_roundtrip_with_flip(tmp_path):
    p = str(tmp_path / "x.tped")
    _write(p, TPED_BASIC)
    ds, _ = _load(p)
    fpath = str(tmp_path / "out.freq")
    freqfile.write_freq(fpath, ds.chroms)
    # re-read into a copy -> identical freqs
    ds2, _ = _load(p)
    for c in ds2.chroms:
        c.freq = None
    freqfile.read_freq(fpath + ".gz", ds2.chroms)
    for a, b in zip(ds.chroms, ds2.chroms):
        np.testing.assert_allclose(np.asarray(b.freq), np.asarray(a.freq),
                                   rtol=1e-6)
    # allele disagreement flips the frequency (src/garlic-data.cpp:1419-1424)
    ds3, _ = _load(p)
    ds3.chroms[0].alleles = np.array(["C", "G"])  # rs1 now 'C'-coded
    freqfile.read_freq(fpath + ".gz", ds3.chroms)
    assert ds3.chroms[0].freq[0] == pytest.approx(0.5)      # symmetric
    ds3.chroms[1].alleles = np.array(["C"])
    freqfile.read_freq(fpath + ".gz", ds3.chroms)


def test_native_freq_writer_matches_python(tmp_path):
    p = str(tmp_path / "x.tped")
    _write(p, TPED_BASIC)
    ds, _ = _load(p)
    a = str(tmp_path / "nat.freq")
    b = str(tmp_path / "py.freq")
    freqfile.write_freq(a, ds.chroms)
    import garlic_tpu.native.build as nb
    saved = nb._lib, nb._tried
    nb._lib, nb._tried = None, True
    try:
        freqfile.write_freq(b, ds.chroms)
    finally:
        nb._lib, nb._tried = saved
    with gzip.open(a + ".gz", "rt") as f:
        ca = f.read()
    with gzip.open(b + ".gz", "rt") as f:
        cb = f.read()
    assert ca == cb


def test_centromere_tables():
    log = RunLog()
    for build in ("hg18", "hg19", "hg38"):
        c = Centromere(build, "defaultcentromere", "defaultcentromere", log)
        # both "chr7" and "7" keys resolve (src/garlic-centromeres.cpp:185+)
        assert c.start("chr7") == c.start("7")
        assert c.end("chr7") > c.start("chr7") > 0
    # unknown chromosome -> warn-once, (0, 0)
    c = Centromere("hg18", "defaultcentromere", "defaultcentromere", log)
    assert c.start("chrWEIRD") == 0
    assert c.end("chrWEIRD") == 0


def test_custom_centromere_file(tmp_path):
    p = str(tmp_path / "c.txt")
    with open(p, "w") as f:
        f.write("chr1 100 200\nchr2 300 400\n")
    # custom files require build "none" (mutually exclusive flags,
    # src/garlic-cli.cpp checkBuildAndCentromereFile)
    c = Centromere("none", p, "defaultcentromere", RunLog())
    assert c.start("chr1") == 100
    assert c.end("chr2") == 400


def test_tgls_gq_conversion(tmp_path):
    """GQ: p_err = 10^(GQ/-10) (src/garlic-data.cpp:1541-1560)."""
    tp = str(tmp_path / "x.tped")
    _write(tp, "1 rs1 0 1000 A A A C\n1 rs2 0 2000 A C C C\n")
    ds, _ = _load(tp)
    tg = str(tmp_path / "x.tgls")
    # TGLS rows mirror TPED's 4 leading columns (src/garlic-data.cpp:1545)
    _write(tg, "1 rs1 0 1000 30 20\n1 rs2 0 2000 10 40\n")
    tgls.read_tgls(tg, ds.chroms, 2, "GQ", RunLog())
    # gl is [individuals, loci]
    np.testing.assert_allclose(
        ds.chroms[0].gl,
        [[10 ** (30 / -10), 10 ** (10 / -10)],
         [10 ** (20 / -10), 10 ** (40 / -10)]])


@pytest.mark.parametrize("seed", range(6))
def test_tped_parser_fuzz_native_vs_python(tmp_path, seed):
    """Randomized TPED content (mixed separators, missing patterns, varied
    allele chars, chromosome runs): native and Python parsers must agree
    exactly."""
    rng = np.random.default_rng(seed + 1000)
    nind = int(rng.integers(1, 12))
    lines = []
    chrom_names = [str(c) for c in rng.choice(
        ["1", "2", "X", "chr3", "22"], size=3, replace=False)]
    for chrom in chrom_names:
        for l in range(int(rng.integers(3, 40))):
            seps = [" ", "\t", "  ", " \t"]
            toks = [chrom, f"rs_{chrom}_{l}",
                    f"{rng.random() * 10:.4f}", str(int(rng.integers(1, 10**8)))]
            for i in range(nind):
                for a in rng.choice(["A", "C", "G", "T", "0"], size=2,
                                    p=[.3, .3, .15, .15, .1]):
                    toks.append(str(a))
            line = ""
            for t in toks:
                line += t + str(rng.choice(seps))
            lines.append(line.rstrip())
    p = str(tmp_path / "fuzz.tped")
    _write(p, "\n".join(lines) + ("\n" if rng.random() < 0.5 else ""))
    ds_n, n_n = _load(p, native=True)
    ds_p, n_p = _load(p, native=False)
    assert n_n == n_p
    assert [c.chrom for c in ds_n.chroms] == [c.chrom for c in ds_p.chroms]
    for a, b in zip(ds_n.chroms, ds_p.chroms):
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.freq, b.freq)
        assert list(a.locus_names) == list(b.locus_names)
        np.testing.assert_array_equal(np.asarray(a.alleles),
                                      np.asarray(b.alleles))


@pytest.mark.parametrize("seed", range(4))
def test_tped_packed_2bit_matches_int8(tmp_path, seed):
    """The fused transpose+pack parser exit (gt_tped_copy_2bit) must emit
    exactly the codes pack_genotypes produces from the int8 matrix,
    including tail-byte padding codes (3 = missing)."""
    from garlic_tpu.ops.device_cache import pack_genotypes

    rng = np.random.default_rng(seed + 500)
    nind = int(rng.integers(1, 40))
    lines = []
    for chrom in ["1", "2"]:
        # odd locus counts exercise the tail-byte path
        for l in range(int(rng.integers(3, 300))):
            toks = [chrom, f"rs{chrom}_{l}", "0",
                    str(int(rng.integers(1, 10**8)))]
            for _ in range(2 * nind):
                toks.append(str(rng.choice(["A", "C", "0"], p=[.5, .4, .1])))
            lines.append(" ".join(toks))
    p = str(tmp_path / "pk.tped")
    _write(p, "\n".join(lines) + "\n")
    from garlic_tpu.native import parse_tped_native
    blks_i8 = parse_tped_native(p, "0", want_fc=False)
    blks_2b = parse_tped_native(p, "0", want_packed=True)
    assert blks_i8 is not None and blks_2b is not None
    for a, b in zip(blks_i8, blks_2b):
        assert b["genotypes"] is None
        L = a["positions"].shape[0]
        Lp = -(-L // 4) * 4
        g = a["genotypes"]
        if Lp != L:
            g = np.concatenate(
                [g, np.full((g.shape[0], Lp - L), -9, np.int8)], axis=1)
        np.testing.assert_array_equal(b["geno2b"], pack_genotypes(
            np.ascontiguousarray(g)))
        np.testing.assert_array_equal(a["freq"], b["freq"])
        np.testing.assert_array_equal(a["positions"], b["positions"])


def test_panel_cache_roundtrip(tmp_path):
    """--tpu-panel-cache: second load comes from the sidecar and must be
    identical to a fresh parse."""
    p = str(tmp_path / "pc.tped")
    _write(p, TPED_BASIC)
    rng = np.random.default_rng(0)
    ds1, n1 = tped.load_tped(p, "0", 0, False, True, RunLog(), rng,
                             panel_cache=True)
    import os as _os
    assert _os.path.exists(p + ".gtpc")
    ds2, n2 = tped.load_tped(p, "0", 0, False, True, RunLog(), rng,
                             panel_cache=True)
    assert n1 == n2
    for a, b in zip(ds1.chroms, ds2.chroms):
        assert a.chrom == b.chrom
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.freq, b.freq)
        assert list(a.locus_names) == list(b.locus_names)
        np.testing.assert_array_equal(np.asarray(a.alleles),
                                      np.asarray(b.alleles))
    # stale cache (tped newer) is ignored
    _os.utime(p)
    ds3, _ = tped.load_tped(p, "0", 0, False, True, RunLog(), rng,
                            panel_cache=True)
    np.testing.assert_array_equal(ds3.chroms[0].genotypes,
                                  ds1.chroms[0].genotypes)


def test_panel_cache_22_chromosomes(tmp_path):
    """v3 container layout with a WGS-shaped chromosome count: ~130 array
    sections must fit the fixed header slot and round-trip exactly
    (phased bits included)."""
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.dirname(__file__))
    from util import make_panel, write_tped
    panel = make_panel(nind=6, nloci_per_chr=(40,) * 22, seed=77)
    p = str(tmp_path / "wgs.tped.gz")
    write_tped(panel, p, str(tmp_path / "wgs.tfam"))
    rng = np.random.default_rng(0)
    ds1, n1 = tped.load_tped(p, "0", 0, True, True, RunLog(), rng,
                             panel_cache=True)
    assert _os.path.exists(p + ".gtpc")
    ds2, n2 = tped.load_tped(p, "0", 0, True, True, RunLog(), rng,
                             panel_cache=True)
    assert n1 == n2 and len(ds2.chroms) == 22
    for a, b in zip(ds1.chroms, ds2.chroms):
        assert a.chrom == b.chrom
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.freq, b.freq)
        np.testing.assert_array_equal(np.asarray(a.first_copy),
                                      np.asarray(b.first_copy))
        assert list(a.locus_names) == list(b.locus_names)


def test_panel_cache_missing_code_mismatch(tmp_path):
    """A cached panel parsed with one --tped-missing code must NOT be
    reused for a run with a different code (the code changes allele
    coding and frequencies)."""
    p = str(tmp_path / "pc2.tped")
    _write(p, TPED_BASIC)
    rng = np.random.default_rng(0)
    tped.load_tped(p, "0", 0, False, True, RunLog(), rng, panel_cache=True)
    import os as _os
    assert _os.path.exists(p + ".gtpc")
    ds_n, _ = tped.load_tped(p, "N", 0, False, True, RunLog(), rng,
                             panel_cache=False)
    ds_c, _ = tped.load_tped(p, "N", 0, False, True, RunLog(), rng,
                             panel_cache=True)
    for a, b in zip(ds_n.chroms, ds_c.chroms):
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.freq, b.freq)


def test_panel_cache_pipeline_identical(tmp_path):
    """Full CLI runs with and without the cache produce identical BED."""
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.dirname(__file__))
    from util import make_panel, write_tped, run_ours
    panel = make_panel(nind=15, nloci_per_chr=(2000,), seed=23)
    write_tped(panel, str(tmp_path / "p.tped.gz"), str(tmp_path / "p.tfam"))
    base = ["--tped", "p.tped.gz", "--tfam", "p.tfam", "--build", "hg18",
            "--winsize", "40", "--error", "0.001", "--lod-cutoff", "1.2",
            "--size-bounds", "300000", "800000", "--kde-subsample", "0"]
    wd = str(tmp_path)
    assert run_ours(wd, base + ["--out", "plain"]) == 0
    assert run_ours(wd, base + ["--tpu-panel-cache", "--out", "warm1"]) == 0
    assert run_ours(wd, base + ["--tpu-panel-cache", "--out", "warm2"]) == 0
    a = open(_os.path.join(wd, "plain.roh.bed")).read()
    assert a == open(_os.path.join(wd, "warm1.roh.bed")).read()
    assert a == open(_os.path.join(wd, "warm2.roh.bed")).read()


def test_freq_blob_cache(tmp_path):
    """Panel-cache runs reuse the cached .freq.gz blob with identical
    decompressed content; rewriting the sidecar (e.g. a changed TPED)
    stales the blob and a fresh write replaces it."""
    import gzip as _gzip
    import os as _os
    import sys as _sys
    import time as _time
    _sys.path.insert(0, _os.path.dirname(__file__))
    from util import make_panel, write_tped, run_ours
    panel = make_panel(nind=12, nloci_per_chr=(1500,), seed=31)
    write_tped(panel, str(tmp_path / "p.tped.gz"), str(tmp_path / "p.tfam"))
    base = ["--tped", "p.tped.gz", "--tfam", "p.tfam", "--build", "hg18",
            "--winsize", "40", "--error", "0.001", "--lod-cutoff", "1.2",
            "--size-bounds", "300000", "800000", "--kde-subsample", "0",
            "--tpu-panel-cache"]
    wd = str(tmp_path)
    assert run_ours(wd, base + ["--out", "a"]) == 0
    blob = _os.path.join(wd, "p.tped.gz.gtpc.freq.gz")
    assert _os.path.exists(blob), "first run must save the freq blob"
    blob_mtime = _os.path.getmtime(blob)
    assert run_ours(wd, base + ["--out", "b"]) == 0
    assert _os.path.getmtime(blob) == blob_mtime, \
        "cached-run freq write must copy the blob, not rewrite it"
    fa = _gzip.open(_os.path.join(wd, "a.freq.gz"), "rt").read()
    fb = _gzip.open(_os.path.join(wd, "b.freq.gz"), "rt").read()
    assert fa == fb and fa.startswith("CHR\tSNP\tPOS\tALLELE\tFREQ")
    # a re-parsed panel (new TPED content -> new sidecar) stales the blob
    _time.sleep(0.02)
    panel2 = make_panel(nind=12, nloci_per_chr=(1500,), seed=32)
    write_tped(panel2, str(tmp_path / "p.tped.gz"), str(tmp_path / "p.tfam"))
    _os.utime(_os.path.join(wd, "p.tped.gz"))
    assert run_ours(wd, base + ["--out", "c"]) == 0
    fc = _gzip.open(_os.path.join(wd, "c.freq.gz"), "rt").read()
    assert fc != fa, "stale blob must not be reused after a re-parse"
    # resampled freqs must never touch the blob
    blob_mtime = _os.path.getmtime(blob)
    assert run_ours(wd, base + ["--out", "d", "--resample", "50"]) == 0
    assert _os.path.getmtime(blob) == blob_mtime
    fd = _gzip.open(_os.path.join(wd, "d.freq.gz"), "rt").read()
    assert fd != fc


def test_resample_deterministic_with_seed(tmp_path):
    """--resample draws Binomial(n, freq)/n; with --tpu-seed the run is
    reproducible (the reference's time(NULL) seeding is not)."""
    p = str(tmp_path / "r.tped")
    _write(p, TPED_BASIC)
    rng1 = np.random.default_rng(42)
    rng2 = np.random.default_rng(42)
    ds1, _ = tped.load_tped(p, "0", 50, False, True, RunLog(), rng1)
    ds2, _ = tped.load_tped(p, "0", 50, False, True, RunLog(), rng2)
    for a, b in zip(ds1.chroms, ds2.chroms):
        np.testing.assert_array_equal(a.freq, b.freq)
        # resampled freqs are multiples of 1/50
        assert np.all(np.abs(a.freq * 50 - np.round(a.freq * 50)) < 1e-9)


def test_genetic_map_interpolation(tmp_path):
    """Linear interpolation between scaffold anchors
    (src/garlic-data.cpp:702-757)."""
    from garlic_tpu.io.genmap import interpolate_genetic_map, load_map_scaffold
    p = str(tmp_path / "m.map")
    _write(p, "chr1 a 0.0 1000\nchr1 b 1.0 2000\nchr1 c 3.0 4000\n")
    c = Centromere("hg18", "defaultcentromere", "defaultcentromere", RunLog())
    scaff = load_map_scaffold(p, c, RunLog())
    pos = np.array([1000, 1500, 2000, 3000, 4000], dtype=np.int64)
    gp, ninterp = interpolate_genetic_map(pos, scaff[0])
    np.testing.assert_allclose(gp, [0.0, 0.5, 1.0, 2.0, 3.0])


def test_native_freq_reader_matches_python(tmp_path):
    """gt_read_freq must reproduce the Python reader bit-for-bit on the
    happy path (incl. allele flips and extra-but-consistent columns) and
    decline (-> Python fallback) on every anomaly the reference errors
    on, so .error text stays byte-compatible."""
    from garlic_tpu.native import native_available, read_freq_native

    if not native_available():
        pytest.skip("native lib unavailable")
    p = str(tmp_path / "x.tped")
    _write(p, TPED_BASIC)
    ds, _ = _load(p)
    fpath = str(tmp_path / "out.freq")
    freqfile.write_freq(fpath, ds.chroms)

    def names_alleles(chroms):
        raw = b"\n".join(c.locus_names.raw if hasattr(c.locus_names, "raw")
                         else "\n".join(c.locus_names).encode()
                         for c in chroms)
        al = np.concatenate([np.asarray(c.alleles) for c in chroms])
        return raw, al

    raw, al = names_alleles(ds.chroms)
    n = sum(c.nloci for c in ds.chroms)
    got = read_freq_native(fpath + ".gz", raw, al, n)
    assert got is not None
    ds2, _ = _load(p)
    for c in ds2.chroms:
        c.freq = None
    freqfile.read_freq(fpath + ".gz", ds2.chroms)
    np.testing.assert_array_equal(
        got, np.concatenate([np.asarray(c.freq) for c in ds2.chroms]))

    # allele flip parity
    al2 = al.copy()
    al2[0] = "Q"
    got2 = read_freq_native(fpath + ".gz", raw, al2, n)
    assert got2 is not None and got2[0] == 1.0 - got[0]
    np.testing.assert_array_equal(got2[1:], got[1:])

    # plain-text (non-gz) file works too
    import gzip as _gz
    with _gz.open(fpath + ".gz", "rb") as f:
        txt = f.read()
    plain = str(tmp_path / "plain.freq")
    with open(plain, "wb") as f:
        f.write(txt)
    np.testing.assert_array_equal(
        read_freq_native(plain, raw, al, n), got)

    # extra-but-consistent sixth column: accepted (matches Python)
    lines = txt.decode().rstrip("\n").split("\n")
    six = "\n".join(l + "\textra" for l in lines) + "\n"
    p6 = str(tmp_path / "six.freq")
    with open(p6, "w") as f:
        f.write(six)
    np.testing.assert_array_equal(read_freq_native(p6, raw, al, n), got)

    # anomalies must return None (Python fallback raises the real error)
    def variant(name, mutate):
        v = str(tmp_path / name)
        with open(v, "w") as f:
            f.write(mutate(lines[:]))
        return read_freq_native(v, raw, al, n)

    assert variant("short.freq",
                   lambda ls: "\n".join(ls[:-1]) + "\n") is None
    assert variant("badcols.freq", lambda ls: "\n".join(
        ls[:2] + ["chr1\tonly\tfour\tcols"] + ls[3:]) + "\n") is None
    assert variant("ragged.freq", lambda ls: "\n".join(
        ls[:2] + [ls[2] + "\textra"] + ls[3:]) + "\n") is None
    assert variant("mismatch.freq", lambda ls: "\n".join(
        ls[:1] + [ls[1].replace("rs1", "rsX")] + ls[2:]) + "\n") is None
    assert variant("badfloat.freq", lambda ls: "\n".join(
        ls[:1] + ["\t".join(ls[1].split("\t")[:4] + ["0.5junk"])]
        + ls[2:]) + "\n") is None


def test_tped_tfam_count_mismatch_errors(tmp_path):
    """Deliberate divergence (PARITY.md): the reference silently
    overwrites the individual count with the TFAM's line count
    (garlic-data.cpp:1957) — shorter TFAM silently truncates the
    analysis, longer TFAM reads past the genotype rows.  garlic-tpu
    must error cleanly in BOTH directions."""
    from garlic_tpu.pipeline import run_main

    p = str(tmp_path / "x.tped")
    _write(p, TPED_BASIC)
    nind = len(TPED_BASIC.splitlines()[0].split()[4:]) // 2
    base = ["--tped", p, "--build", "hg18", "--winsize", "2",
            "--error", "0.001", "--kde-subsample", "0",
            "--lod-cutoff", "1.0", "--size-bounds", "1000", "2000"]
    for extra in (-1, +1):
        tf = str(tmp_path / f"t{extra}.tfam")
        with open(tf, "w") as f:
            for k in range(nind + extra):
                f.write(f"P1 ind{k} 0 0 1 1\n")
        out = str(tmp_path / f"o{extra}")
        rc = run_main(base + ["--tfam", tf, "--out", out])
        assert rc != 0
        err = open(out + ".error").read()
        assert "TPED and TFAM disagree on individual count" in err


def _tgls_chroms(tmp_path, tag=""):
    """Two-chromosome panel skeleton for TGLS reader tests."""
    tp = str(tmp_path / f"t{tag}.tped")
    _write(tp, TPED_BASIC)
    ds, _ = _load(tp)
    return ds.chroms


def test_tgls_native_matches_python(tmp_path):
    """The native TGLS reader (token dictionary / fallback modes) yields
    the same gl matrices as the Python line reader, and the dictionary
    form round-trips through the lazy `gl` materialization."""
    from garlic_tpu.native import native_available, parse_tgls_native

    if not native_available():
        pytest.skip("native library unavailable")
    cases = {
        # GQ-style small ints -> dictionary mode
        "dict": ("1 a 0 1 30 20 45 7\n1 b 0 2 20 20 30 30\n"
                 "2 c 0 3 7 45 45 20\n", True),
        # 9-16 char tokens (typical GL floats) still dictionary-compress
        "midlen": ("1 a 0 1 -0.00123456789 -0.5 -0.25 -1\n"
                   "1 b 0 2 -1 -0.5 -0.00123456789 0\n"
                   "2 c 0 3 0 0 -0.25 -1\n", True),
        # > 16-char tokens -> fallback doubles
        "long": ("1 a 0 1 -0.001234567890123456 -0.5 -0.25 -1\n"
                 "1 b 0 2 -1 -0.5 -0.001234567890123456 0\n"
                 "2 c 0 3 0 0 -0.25 -1\n", False),
    }
    for name, (text, want_dict) in cases.items():
        tg = str(tmp_path / f"{name}.tgls.gz")
        _write(tg, text)
        a = _tgls_chroms(tmp_path, name + "a")
        tgls._read_tgls_python(tg, a, 4, "GQ" if want_dict else "GL",
                               RunLog())
        b = _tgls_chroms(tmp_path, name + "b")
        tgls.read_tgls(tg, b, 4, "GQ" if want_dict else "GL", RunLog())
        for ca, cb in zip(a, b):
            assert (cb.gl_codes is not None) == want_dict
            np.testing.assert_array_equal(np.asarray(cb.gl),
                                          np.asarray(ca.gl))


def test_tgls_native_dict_overflow(tmp_path):
    """> 255 distinct tokens flips the native reader to the full-double
    fallback mid-parse with values identical to the Python reader."""
    from garlic_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    from .util import make_panel, write_tped

    panel = make_panel(nind=9, nloci_per_chr=(120, 80), seed=6)
    tp = str(tmp_path / "of.tped.gz")
    write_tped(panel, tp, str(tmp_path / "of.tfam"))
    rng = np.random.default_rng(11)
    rows = []
    for ci, chrom in enumerate(panel.chrom_names):
        for l, pos in enumerate(panel.positions[ci]):
            vals = rng.integers(0, 3000, size=9)  # ~1500 distinct tokens
            rows.append(f"{chrom} rs{ci}_{l} 0 {int(pos)} "
                        + " ".join(map(str, vals)))
    tg = str(tmp_path / "of.tgls.gz")
    _write(tg, "\n".join(rows) + "\n")

    def chroms():
        ds, _ = tped.load_tped(tp, "0")
        return ds.chroms

    a = chroms()
    tgls._read_tgls_python(tg, a, 9, "PL", RunLog())
    b = chroms()
    tgls.read_tgls(tg, b, 9, "PL", RunLog())
    for ca, cb in zip(a, b):
        assert cb.gl_codes is None  # overflowed out of dictionary mode
        np.testing.assert_array_equal(np.asarray(cb.gl), np.asarray(ca.gl))


def test_tgls_native_error_parity_with_python(tmp_path):
    """Truncated and extra-column TGLS files produce the same logged
    error via the native reader as via the Python reader (whose text is
    oracle-verified in test_oracle.py)."""
    from garlic_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")

    class Cap:
        def __init__(self):
            self.calls = []

        def err(self, *a, nl=True):
            self.calls.append((a, nl))

    good = "1 a 0 1 30 20 45 7\n1 b 0 2 20 20 30 30\n2 c 0 3 7 45 45 20\n"
    cases = {
        "trunc.tgls": good.rsplit("\n", 2)[0] + "\n",   # one row short
        "extra.tgls": good.replace("30 30\n", "30 30 5\n"),
        "short.tgls": good.replace("45 45 20", "45 45"),
    }
    for name, text in cases.items():
        tg = str(tmp_path / name)
        _write(tg, text)
        ca, cb = Cap(), Cap()
        with pytest.raises(tgls.TglsError):
            tgls._read_tgls_python(tg, _tgls_chroms(tmp_path, name + "a"),
                                   4, "GQ", ca)
        with pytest.raises(tgls.TglsError):
            tgls.read_tgls(tg, _tgls_chroms(tmp_path, name + "b"),
                           4, "GQ", cb)
        assert ca.calls == cb.calls, (name, ca.calls, cb.calls)


def test_tgls_sidecar_roundtrip(tmp_path):
    """--tpu-panel-cache TGLS sidecar: identical gl data from the .gtlc
    on warm loads, a re-written TGLS file misses (mtime), and a changed
    panel shape misses (row counts)."""
    from garlic_tpu.io import panelcache
    from garlic_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    import time

    tp = str(tmp_path / "s.tped")
    _write(tp, TPED_BASIC)
    text = "1 a 0 1 30 20 45 7\n1 b 0 2 20 20 30 30\n2 c 0 3 7 45 45 20\n"
    tg = str(tmp_path / "s.tgls.gz")
    _write(tg, text)

    def chroms():
        ds, _ = tped.load_tped(tp, "0")
        return ds.chroms

    a = chroms()
    tgls.read_tgls(tg, a, 4, "GQ", RunLog(), panel_cache=True)
    assert os.path.exists(panelcache.tgls_cache_path(tg))
    b = chroms()
    tgls.read_tgls(tg, b, 4, "GQ", RunLog(), panel_cache=True)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(cb.gl_codes),
                                      np.asarray(ca.gl_codes))
        np.testing.assert_array_equal(np.asarray(cb.gl), np.asarray(ca.gl))
    # one sidecar serves any --gl-type (raw values cached)
    c = chroms()
    tgls.read_tgls(tg, c, 4, "PL", RunLog(), panel_cache=True)
    ref = chroms()
    tgls._read_tgls_python(tg, ref, 4, "PL", RunLog())
    for cc, cr in zip(c, ref):
        np.testing.assert_array_equal(np.asarray(cc.gl), np.asarray(cr.gl))
    # shape mismatch (different panel) -> miss, not wrong data
    assert panelcache.load_tgls_cache(tg, 4, [2, 2]) is None
    assert panelcache.load_tgls_cache(tg, 5, [2, 1]) is None
    # rewritten TGLS -> stale sidecar ignored
    time.sleep(0.02)
    _write(tg, text.replace("30 20", "10 10"))
    os.utime(panelcache.tgls_cache_path(tg),
             (time.time() - 10, time.time() - 10))
    d = chroms()
    tgls.read_tgls(tg, d, 4, "GQ", RunLog(), panel_cache=True)
    assert np.asarray(d[0].gl)[0, 0] == 10 ** (10 / -10)


def test_tgls_sidecar_vals_mode(tmp_path):
    """Fallback (full-double) TGLS parses round-trip through the sidecar
    too."""
    from garlic_tpu.io import panelcache
    from garlic_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    tp = str(tmp_path / "v.tped")
    _write(tp, TPED_BASIC)
    text = ("1 a 0 1 -0.001234567890123456 -0.5 -0.25 -1\n"
            "1 b 0 2 -1 -0.5 -0.001234567890123456 0\n"
            "2 c 0 3 0 0 -0.25 -1\n")
    tg = str(tmp_path / "v.tgls.gz")
    _write(tg, text)

    def chroms():
        ds, _ = tped.load_tped(tp, "0")
        return ds.chroms

    a = chroms()
    tgls.read_tgls(tg, a, 4, "GL", RunLog(), panel_cache=True)
    assert os.path.exists(panelcache.tgls_cache_path(tg))
    b = chroms()
    tgls.read_tgls(tg, b, 4, "GL", RunLog(), panel_cache=True)
    for ca, cb in zip(a, b):
        assert cb.gl_codes is None
        np.testing.assert_array_equal(np.asarray(cb.gl), np.asarray(ca.gl))


def test_tgls_panel_cache_pipeline_identical(tmp_path):
    """TGLS CLI runs with and without --tpu-panel-cache produce identical
    BED (the .gtlc sidecar round-trip is output-invariant), and the warm
    run actually loads the sidecar."""
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.dirname(__file__))
    from garlic_tpu.io import panelcache
    from util import make_panel, run_ours, write_tgls, write_tped
    panel = make_panel(nind=15, nloci_per_chr=(2000,), seed=29)
    write_tped(panel, str(tmp_path / "p.tped.gz"), str(tmp_path / "p.tfam"))
    write_tgls(panel, str(tmp_path / "p.tgls.gz"), "GQ")
    base = ["--tped", "p.tped.gz", "--tfam", "p.tfam", "--tgls",
            "p.tgls.gz", "--gl-type", "GQ", "--build", "hg18",
            "--winsize", "40", "--error", "0.001", "--lod-cutoff", "1.2",
            "--size-bounds", "300000", "800000", "--kde-subsample", "0"]
    wd = str(tmp_path)
    assert run_ours(wd, base + ["--out", "plain"]) == 0
    assert run_ours(wd, base + ["--tpu-panel-cache", "--out", "warm1"]) == 0
    assert _os.path.exists(
        panelcache.tgls_cache_path(str(tmp_path / "p.tgls.gz")))
    assert run_ours(wd, base + ["--tpu-panel-cache", "--out", "warm2"]) == 0
    a = open(_os.path.join(wd, "plain.roh.bed")).read()
    assert a == open(_os.path.join(wd, "warm1.roh.bed")).read()
    assert a == open(_os.path.join(wd, "warm2.roh.bed")).read()


@pytest.mark.parametrize("seed", range(6))
def test_tgls_parser_fuzz_native_vs_python(tmp_path, seed):
    """Randomized TGLS content (mixed separators, CRLF, token universes
    spanning dictionary / long-token / overflow regimes, scientific
    notation): native and Python readers must agree exactly."""
    from garlic_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(seed + 500)
    nind = int(rng.integers(1, 10))
    nloci = (int(rng.integers(3, 30)), int(rng.integers(2, 20)))
    # token universe regime per seed
    regime = seed % 3
    if regime == 0:     # small ints (dictionary mode)
        universe = [str(v) for v in rng.integers(0, 99, size=12)]
    elif regime == 1:   # long/scientific tokens (fallback mode)
        universe = [f"{rng.random():.12f}", "1e-3", "2.5E-2", "-0.125",
                    f"-{rng.random():.10f}", "0"]
    else:               # wide int universe (overflow regime at scale)
        universe = [str(v) for v in rng.integers(0, 5000, size=40)]
    # build a TPED skeleton with the same per-chromosome row counts
    tped_lines, tgls_lines = [], []
    for ci, chrom in enumerate(["1", "2"]):
        for l in range(nloci[ci]):
            pos = 1000 + l * 777
            g = " ".join(str(a) for i in range(nind)
                         for a in rng.choice(["A", "C", "0"], size=2))
            tped_lines.append(f"{chrom} rs{ci}_{l} 0 {pos} {g}")
            seps = [" ", "\t", "  "]
            row = ""
            for t in [chrom, f"rs{ci}_{l}", "0", str(pos)] + \
                    [str(rng.choice(universe)) for _ in range(nind)]:
                row += t + str(rng.choice(seps))
            tgls_lines.append(row.rstrip())
    tp = str(tmp_path / "f.tped")
    _write(tp, "\n".join(tped_lines) + "\n")
    tg = str(tmp_path / "f.tgls")
    text = "\n".join(tgls_lines)
    if rng.random() < 0.3:
        text = text.replace("\n", "\r\n")
    _write(tg, text + ("\n" if rng.random() < 0.5 else ""))
    gl_type = ["GQ", "PL", "GL"][seed % 3]

    def chroms():
        ds, _ = tped.load_tped(tp, "0")
        return ds.chroms

    a = chroms()
    tgls._read_tgls_python(tg, a, nind, gl_type, RunLog())
    b = chroms()
    tgls.read_tgls(tg, b, nind, gl_type, RunLog())
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(cb.gl), np.asarray(ca.gl))
