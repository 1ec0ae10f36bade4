"""Differential fuzzing vs the reference binary: randomized deterministic
configs x randomized panels, BED/freq byte-diffed.

The fixed-config oracle tests (test_oracle.py) pin one flag combination
each; this harness samples the *joint* flag space (winsize, error,
max-gap, overlap-frac, pinned vs auto cutoff/bounds, nclust, missing
code, gap structure) so edge interactions between stages get coverage.
Only stages the reference seeds from time(NULL) are excluded
(--kde-subsample, --ld-subsample, --resample are pinned off - SURVEY §4).

A handful of seeds run in CI; crank GARLIC_FUZZ_SEEDS for a campaign:
    GARLIC_FUZZ_SEEDS=0:200 python -m pytest tests/test_fuzz_oracle.py -q

Campaign results (2026-08-17):
- plain path, seeds 0:240 — 199 strict byte-identical BED+freq, 26
  waived FIGTree-tail cutoff flips (KDE grids within eps in every one),
  15 oracle GSL aborts our engine survived cleanly
- variant paths (weighted/TGLS GQ|PL|GL/cm/weighted+TGLS), seeds 0:40 —
  40/40 BED byte-identical
- mesh consistency (random 2x4/4x2/8x1/1x8 meshes vs single device),
  seeds 0:20 — 20/20 identical
Zero unexplained divergences.

Campaign re-run (2026-08-18, after the round-2-final engine: fused
weighted Phase I, VPU select/slice kernels, plane/aux HBM caches, UCS4
sidecar, split edge extractor, native freq reader): plain seeds 0:300,
variants (now incl. --phased and phased+TGLS) 0:32, mesh 0:8, streaming
0:8 — all green, zero divergences.

Campaign extension (2026-08-19): seeds 300:380 across all spaces —
88/88 green, zero divergences.

Round-3 campaigns (2026-08-19, tie-patrol engine + native TGLS reader):
- combined: plain 380:420, variants 64:112, fast==exact ties 24:56,
  weighted ties 32:48, streaming 8:16, mesh 6:12 — 150/150 green;
- variants 112:144 re-run on the 16-char-dictionary TGLS reader —
  32/32 green.  Zero divergences anywhere.
Campaign hygiene: the fast==exact tie classes run each engine in a
fresh subprocess — XLA's CPU backend segfaults after ~30 large
in-process compilations (see util.run_ours_subprocess).

Final-HEAD batch (2026-08-19, after the edge-cap scaling / 1000x1M
fix): plain 420:450, variants 144:168, ties 56:72, weighted ties 48:60,
streaming 16:22, mesh 12:16 — 92/92 green, zero divergences.

Round-4 campaign (2026-08-20, exact Phase-II sampler + gt_gsl_sd +
randomized-oracle acceptance): plain 450:700 (250 seeds) — 250/250
green.  Of the ~97 auto-cutoff draws: 70 cutoffs matched the oracle's
exactly, 27 hit the randomized-oracle class and EVERY one passed the
strict three-part verification (.kde x byte-identical + oracle draw
FIGTree-reachable + pinned-cutoff oracle BED byte-identical).  The old
"waiver" (grids within eps) is gone — divergences are now machine-
verified as the oracle's own randomness (BASELINE.md round 4: FIGTree
k-center clustering is time(NULL)-seeded inside the oracle binary).
Variants 168:200, ties 72:80, weighted ties 60:66, streaming 22:28,
mesh 16:20 — 56/56 green.  Zero unexplained divergences.

Round-4 final-HEAD campaign (2026-08-20, after: per-host sharded input +
freq psum, tie patrol on every engine config, scalar-core-free edge
compaction + bf16 counts, batched tie repair, thinned exact Phase-II
kernel, hybrid KDE, device GMM): plain 700:800, variants 200:224, ties
80:96, weighted ties 66:74, mesh 20:26, mesh-weighted ties 3:9 (new
class), streaming 28:34, mesh-streaming 2:6 (new class) — 170/170
green, zero unexplained divergences.  Extension after the review-fix
batch (cluster-wide freq gating, degenerate-split guard, in-kernel
threshold ceil, GMM size gate, TGLS sharding): plain 800:950, variants
224:256, ties 96:112, weighted ties 74:82, mesh-weighted 9:15, mesh
26:32, streaming 34:40, mesh-streaming 6:10 — 228/228 green.  Round-4
total: 306 + 170 + 228 = 704 cases, zero unexplained divergences.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from .util import (make_panel, read_text, run_oracle, run_ours,
                   run_ours_subprocess, write_map_scaffold, write_tgls,
                   write_tped)


def _seed_range(env="GARLIC_FUZZ_SEEDS", default="0:4"):
    spec = os.environ.get(env, default)
    lo, hi = (int(x) for x in spec.split(":"))
    return range(lo, hi)


def _draw_config(rng: np.random.Generator):
    """One random (panel_kw, args) pair from the deterministic flag space."""
    nind = int(rng.integers(30, 55))
    nchrom = int(rng.integers(1, 4))
    nloci = tuple(int(rng.integers(5000, 9000)) for _ in range(nchrom))
    panel_kw = dict(
        nind=nind, nloci_per_chr=nloci,
        seed=int(rng.integers(0, 2**31)),
        roh_rate=float(rng.uniform(0.2, 0.6)),
        missing_rate=float(rng.uniform(0.0, 0.01)),
        big_gap_every=int(rng.choice([0, 0, 400, 900])),
        spacing_mean=int(rng.integers(1500, 5000)))
    winsize = int(rng.integers(20, 110))
    args = ["--build", str(rng.choice(["hg18", "hg19", "hg38"])),
            "--winsize", str(winsize),
            "--error", f"{rng.uniform(5e-4, 5e-3):.6f}",
            "--kde-subsample", "0",
            "--max-gap", str(int(rng.choice([100000, 200000, 500000]))),
            "--overlap-frac", f"{rng.uniform(0.1, 0.9):.3f}"]
    # cutoff: pinned ~60%, auto-KDE otherwise (deterministic with
    # --kde-subsample 0; the KDE itself is exact vs FIGTree eps=1e-2,
    # which can flip the cutoff on tiny panels - panels here are >=30x5k)
    if rng.random() < 0.6:
        args += ["--lod-cutoff", f"{rng.uniform(0.5, 3.0):.3f}"]
    # bounds: pinned ~60%, auto-GMM otherwise
    if rng.random() < 0.6:
        lo = int(rng.integers(200000, 600000))
        args += ["--size-bounds", str(lo),
                 str(lo + int(rng.integers(200000, 900000)))]
    else:
        args += ["--nclust", str(int(rng.choice([2, 3])))]
    return panel_kw, args


def _selected_cutoff(logtext: str):
    for ln in logtext.splitlines():
        if ln.startswith("Selected LOD score cutoff:"):
            return ln.split(":", 1)[1].strip()
    return None


def _assert_randomized_oracle_class(wd, oracle_bin, args, ca, cb,
                                    ours_rc) -> None:
    """A cutoff divergence is accepted ONLY as the documented
    randomized-oracle class (BASELINE.md round 4: FIGTree's k-center
    clustering is time(NULL)-seeded inside the oracle, so its Phase II —
    and on near-tie densities its cutoff — varies run-to-run).  Requires:

      1. byte-identical .kde x columns (our bandwidth/grid math is
         bit-exact; only FIGTree's approximated y differs);
      2. the oracle's draw among our cutoff_tie_probe rivals (the flip is
         reachable at the FIGTree error scale);
      3. when our run completed, the oracle re-run with OUR cutoff pinned
         reproduces our BED byte-for-byte (everything downstream of the
         randomized selection is exact)."""
    import glob

    from .util import oracle_cutoff_reachable

    ka = sorted(glob.glob(os.path.join(wd, "oracle.*.kde")))
    kb = sorted(glob.glob(os.path.join(wd, "ours.*.kde")))
    assert len(ka) == 1 and len(kb) == 1, ("cutoffs differ without a "
                                           "single KDE pair", ca, cb, args)
    xa = [line.split()[0] for line in read_text(ka[0]).splitlines()
          if line.strip()]
    xb = [line.split()[0] for line in read_text(kb[0]).splitlines()
          if line.strip()]
    assert xa == xb, ("cutoffs differ AND .kde x columns differ — a real "
                      "bug", ca, cb, args)
    kde = np.loadtxt(kb[0])
    wsize = int(args[args.index("--winsize") + 1])
    if not oracle_cutoff_reachable(kde, wsize, ca, cb):
        # the reachability model is a heuristic bound on FIGTree's
        # correlated error — when a draw escapes it, test oracle
        # SELF-instability directly: re-run the oracle (time(NULL)
        # reseeds each second); a different cutoff on any re-draw
        # proves the oracle does not reproduce itself on this density
        # (criterion 3 below still carries the correctness proof).  A
        # STABLE oracle that disagrees with us stays a hard failure.
        import time as _time
        redraws = set()
        for _ in range(3):
            _time.sleep(1.1)
            r = run_oracle(oracle_bin, wd, args + ["--out", "oracle_rr"])
            if r.returncode == 0:
                c = _selected_cutoff(read_text(
                    os.path.join(wd, "oracle_rr.log")))
                if c is not None:
                    redraws.add(c)
        assert (len(redraws - {ca}) > 0), \
            ("oracle cutoff not FIGTree-reachable from ours AND the "
             "oracle reproduces it across re-runs — a real bug",
             ca, cb, sorted(redraws), args)
    if ours_rc != 0:
        return  # our exact cutoff left e.g. too few ROH for the GMM
    pinned = args + ["--lod-cutoff", cb, "--out", "oracle_pin"]
    r = run_oracle(oracle_bin, wd, pinned)
    if r.returncode != 0 and "gsl" in r.stderr.lower():
        return  # oracle GSL abort at our cutoff; nothing to compare
    assert r.returncode == 0, (pinned, r.stderr[-1500:])
    pa = read_text(os.path.join(wd, "oracle_pin.roh.bed"))
    pb = read_text(os.path.join(wd, "ours.roh.bed"))
    assert pa == pb, ("oracle(pinned to our cutoff) BED differs — a real "
                      "bug beyond the randomized selection", ca, cb, args)


@pytest.mark.slow
@pytest.mark.parametrize("seed", _seed_range())
def test_fuzz_config_bed_identical(oracle_bin, tmp_path, seed):
    rng = np.random.default_rng(10_000 + seed)
    panel_kw, args = _draw_config(rng)
    panel = make_panel(**panel_kw)
    write_tped(panel, str(tmp_path / "f.tped.gz"), str(tmp_path / "f.tfam"))
    wd = str(tmp_path)
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    r = run_oracle(oracle_bin, wd, args + ["--out", "oracle"])
    if r.returncode != 0 and "gsl" in r.stderr.lower():
        # the reference hard-aborts in GSL on degenerate GMM inputs
        # (gsl: log.c domain error -> abort()); nothing to byte-compare.
        # Our engine must survive the same input without a traceback.
        rc = run_ours(wd, args + ["--out", "ours"])
        assert rc in (0, 1, -1, 2), (args, rc)
        return
    assert r.returncode == 0, (args, r.stderr[-1500:])
    rc = run_ours(wd, args + ["--out", "ours"])
    fa = read_text(os.path.join(wd, "oracle.freq.gz"))
    fb = read_text(os.path.join(wd, "ours.freq.gz"))
    assert fa == fb, ("freq differs", args)
    ca = _selected_cutoff(read_text(os.path.join(wd, "oracle.log")))
    cb = _selected_cutoff(read_text(os.path.join(wd, "ours.log")))
    if ca != cb and ca is not None and cb is not None:
        # auto-cutoff diverged: accepted ONLY as the verified
        # randomized-oracle class (strict three-part criterion)
        _assert_randomized_oracle_class(wd, oracle_bin, args, ca, cb, rc)
        stats = os.environ.get("GARLIC_FUZZ_STATS")
        if stats:  # campaign bookkeeping: measure the class rate
            with open(stats, "a") as f:
                f.write(f"flip seed={seed} oracle={ca} ours={cb}\n")
        return
    if ca is not None and os.environ.get("GARLIC_FUZZ_STATS"):
        with open(os.environ["GARLIC_FUZZ_STATS"], "a") as f:
            f.write(f"auto-equal seed={seed} cutoff={cb}\n")
    assert rc == 0, args
    a = read_text(os.path.join(wd, "oracle.roh.bed"))
    b = read_text(os.path.join(wd, "ours.roh.bed"))
    assert a == b, ("BED differs", args,
                    [(i, x, y) for i, (x, y) in enumerate(
                        zip(a.splitlines(), b.splitlines())) if x != y][:5])


def _draw_variant_config(rng: np.random.Generator):
    """Random config for the weighted/TGLS/cm variant fuzz: the variant
    paths run the LD band + wLOD kernels, the genetic-map interpolation,
    or the per-genotype-likelihood LOD table — each with its own masking
    and accumulation quirks.  Cutoff/bounds are PINNED (the wLOD score
    scale makes auto-KDE degenerate far more often than plain LOD, and
    the divergence waiver would dominate)."""
    nind = int(rng.integers(25, 45))
    nchrom = int(rng.integers(1, 3))
    nloci = tuple(int(rng.integers(4000, 7000)) for _ in range(nchrom))
    panel_kw = dict(
        nind=nind, nloci_per_chr=nloci,
        seed=int(rng.integers(0, 2**31)),
        roh_rate=float(rng.uniform(0.2, 0.5)),
        missing_rate=float(rng.uniform(0.0, 0.008)),
        spacing_mean=int(rng.integers(2000, 4500)))
    winsize = int(rng.integers(25, 75))
    mode = rng.choice(["weighted", "tgls", "cm", "weighted+tgls"])
    args = ["--build", "hg18", "--winsize", str(winsize),
            "--error", f"{rng.uniform(5e-4, 3e-3):.6f}",
            "--kde-subsample", "0",
            "--overlap-frac", f"{rng.uniform(0.15, 0.6):.3f}"]
    gl_type = None
    if "tgls" in mode:
        gl_type = str(rng.choice(["GQ", "PL", "GL"]))
        args += ["--tgls", "f.tgls.gz", "--gl-type", gl_type]
    if "weighted" in mode:
        args += ["--map", "f.map.gz", "--weighted", "--ld-subsample", "0",
                 "--lod-cutoff", f"{rng.uniform(20, 80):.2f}",
                 "--size-bounds", "300000", "800000"]
        if rng.random() < 0.5:     # orthogonal to USE_GL in the reference
            args += ["--phased"]   # r2 LD from first-copy haplotype bits
    elif mode == "cm":
        lo = rng.uniform(0.3, 0.8)
        args += ["--map", "f.map.gz", "--cm",
                 "--lod-cutoff", f"{rng.uniform(0.8, 2.0):.3f}",
                 "--size-bounds", f"{lo:.3f}", f"{lo + rng.uniform(0.3, 1.0):.3f}"]
    else:  # tgls-only: pinned cutoff/bounds
        args += ["--lod-cutoff", f"{rng.uniform(0.8, 2.5):.3f}",
                 "--size-bounds", "300000", "900000"]
    return panel_kw, args, mode, gl_type


@pytest.mark.slow
@pytest.mark.parametrize("seed", _seed_range("GARLIC_FUZZ_VARIANT_SEEDS",
                                             "0:3"))
def test_fuzz_variant_paths_bed_identical(oracle_bin, tmp_path, seed):
    """Weighted (LD+wLOD), TGLS (GQ/PL/GL), --cm, and weighted+TGLS combo
    configs byte-diffed vs the oracle."""
    rng = np.random.default_rng(77_000 + seed)
    panel_kw, args, mode, gl_type = _draw_variant_config(rng)
    panel = make_panel(**panel_kw)
    wd = str(tmp_path)
    write_tped(panel, f"{wd}/f.tped.gz", f"{wd}/f.tfam")
    if "--map" in args:
        write_map_scaffold(panel, f"{wd}/f.map.gz")
    if gl_type is not None:
        write_tgls(panel, f"{wd}/f.tgls.gz", gl_type=gl_type,
                   seed=int(rng.integers(0, 2**31)))
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    r = run_oracle(oracle_bin, wd, args + ["--out", "oracle"])
    assert r.returncode == 0, (mode, args, r.stderr[-1500:])
    rc = run_ours(wd, args + ["--out", "ours"])
    assert rc == 0, (mode, args)
    a = read_text(os.path.join(wd, "oracle.roh.bed"))
    b = read_text(os.path.join(wd, "ours.roh.bed"))
    assert a == b, ("BED differs", mode, args,
                    [(i, x, y) for i, (x, y) in enumerate(
                        zip(a.splitlines(), b.splitlines())) if x != y][:5])


@pytest.mark.slow
@pytest.mark.parametrize("seed", _seed_range("GARLIC_FUZZ_STREAM_SEEDS",
                                             "0:2"))
def test_fuzz_streaming_identical_to_resident(tmp_path, seed, monkeypatch):
    """GARLIC_TPU_HBM_BUDGET=1 forces per-chromosome rematerialization
    (LazyWin); streamed runs must reproduce the resident BED exactly for
    random shapes/winsizes."""
    rng = np.random.default_rng(66_000 + seed)
    panel_kw, args = _draw_config(rng)
    panel = make_panel(**panel_kw)
    wd = str(tmp_path)
    write_tped(panel, f"{wd}/f.tped.gz", f"{wd}/f.tfam")
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam",
            "--tpu-engine", "fast"] + args
    rc1 = run_ours(wd, args + ["--out", "resident"])
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "1")
    rc2 = run_ours(wd, args + ["--out", "streamed"])
    assert (rc1 == 0) == (rc2 == 0), (args, rc1, rc2)
    if rc1 != 0:
        return
    a = read_text(os.path.join(wd, "resident.roh.bed"))
    b = read_text(os.path.join(wd, "streamed.roh.bed"))
    assert a == b, ("streamed BED differs from resident", args)


@pytest.mark.slow
@pytest.mark.parametrize("seed", _seed_range("GARLIC_FUZZ_MESH_SEEDS", "0:3"))
def test_fuzz_mesh_identical_to_single(tmp_path, seed):
    """--tpu-mesh sharded runs must produce BED identical to the
    single-device engine for random shapes/winsizes (the halo'd window
    scan + psum'd KDE/GMM collectives vs the plain path).  No oracle
    needed: this is an internal consistency fuzz on the virtual mesh."""
    rng = np.random.default_rng(55_000 + seed)
    panel_kw, args = _draw_config(rng)
    panel = make_panel(**panel_kw)
    wd = str(tmp_path)
    write_tped(panel, f"{wd}/f.tped.gz", f"{wd}/f.tfam")
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam",
            "--tpu-engine", "fast"] + args
    mesh = str(rng.choice(["2x4", "4x2", "8x1", "1x8"]))
    rc1 = run_ours(wd, args + ["--out", "single"])
    rc2 = run_ours(wd, args + ["--tpu-mesh", mesh, "--out", "meshed"])
    assert (rc1 == 0) == (rc2 == 0), (args, mesh, rc1, rc2)
    if rc1 != 0:
        return  # both failed cleanly (degenerate GMM at this config)
    a = read_text(os.path.join(wd, "single.roh.bed"))
    b = read_text(os.path.join(wd, "meshed.roh.bed"))
    assert a == b, ("mesh BED differs from single-device", mesh, args)


@pytest.mark.slow
@pytest.mark.parametrize("seed", _seed_range("GARLIC_FUZZ_TIE_SEEDS", "0:4"))
def test_fuzz_fast_equals_exact(tmp_path, seed):
    """The f32 fast engine must produce BED identical to the exact f64
    engine on the SAME inputs: any window sum inside the f32 error band
    around the cutoff is caught by the tie patrol and its row recomputed
    exactly (pipeline._tie_band / assembly._repair_rows).  Random panels
    + winsizes spanning both Pallas window-sum regimes."""
    rng = np.random.default_rng(77_000 + seed)
    panel_kw, args = _draw_config(rng)
    # span the unrolled (<= 64) and cumsum (> 64) kernel paths
    wi = args.index("--winsize")
    args[wi + 1] = str(int(rng.choice([31, 60, 90, 130])))
    if "--lod-cutoff" not in args:
        # pin the cutoff: the engines' KDE grids can legitimately argmin
        # one point apart; this test is strictly about Phase-I ties
        args += ["--lod-cutoff", f"{rng.uniform(0.2, 2.0):.4f}"]
    panel = make_panel(**panel_kw)
    write_tped(panel, str(tmp_path / "f.tped.gz"), str(tmp_path / "f.tfam"))
    wd = str(tmp_path)
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    # fresh subprocesses: long in-process campaigns segfault XLA's CPU
    # compiler after ~30 large compilations (see util.run_ours_subprocess)
    rce = run_ours_subprocess(wd, args + ["--tpu-engine", "exact",
                                          "--out", "ex"])
    rcf = run_ours_subprocess(wd, args + ["--tpu-engine", "fast",
                                          "--out", "fa"])
    assert rce == rcf
    if rce != 0:
        return  # degenerate GMM/cutoff: both engines must agree on failure
    a = open(os.path.join(wd, "ex.roh.bed")).read()
    b = open(os.path.join(wd, "fa.roh.bed")).read()
    assert a == b


@pytest.mark.slow
@pytest.mark.parametrize("seed",
                         _seed_range("GARLIC_FUZZ_TIE_W_SEEDS", "0:4"))
def test_fuzz_weighted_fast_equals_exact(tmp_path, seed):
    """Weighted tie patrol: the f32 fast engine's BED equals the exact
    f64 engine's on the same weighted inputs — the band scale rides each
    DeviceWin as a device scalar (max |window term|), suspect windows
    re-derive their fresh-sum f64 value (the reference's wLOD has no
    rolling update, so that IS the oracle value)."""
    rng = np.random.default_rng(88_000 + seed)
    panel_kw, args = _draw_config(rng)
    wi = args.index("--winsize")
    args[wi + 1] = str(int(rng.choice([25, 40, 70])))
    if "--lod-cutoff" not in args:
        args += ["--lod-cutoff", f"{rng.uniform(0.2, 2.0):.4f}"]
    args += ["--map", "f.map.gz", "--weighted",
             "--tpu-seed", str(seed)]  # same LD subsample both engines
    if rng.random() < 0.5:
        args += ["--ld-subsample", str(int(rng.integers(10, 25)))]
    if rng.random() < 0.3:
        args += ["--phased"]
    panel = make_panel(**panel_kw)
    write_tped(panel, str(tmp_path / "f.tped.gz"), str(tmp_path / "f.tfam"))
    write_map_scaffold(panel, str(tmp_path / "f.map.gz"))
    wd = str(tmp_path)
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    # fresh subprocesses: long in-process campaigns segfault XLA's CPU
    # compiler after ~30 large compilations (see util.run_ours_subprocess)
    rce = run_ours_subprocess(wd, args + ["--tpu-engine", "exact",
                                          "--out", "ex"])
    rcf = run_ours_subprocess(wd, args + ["--tpu-engine", "fast",
                                          "--out", "fa"])
    assert rce == rcf
    if rce != 0:
        return
    a = open(os.path.join(wd, "ex.roh.bed")).read()
    b = open(os.path.join(wd, "fa.roh.bed")).read()
    assert a == b


@pytest.mark.slow
@pytest.mark.parametrize("seed",
                         _seed_range("GARLIC_FUZZ_TIE_MW_SEEDS", "0:3"))
def test_fuzz_mesh_weighted_fast_equals_exact(tmp_path, seed):
    """Mesh-weighted tie patrol (round 4): --tpu-mesh weighted runs now
    ship a pmax'd tie_scale (max finite |window term| over the whole
    mesh), so the sharded f32 wLOD BED equals the exact f64 engine's by
    construction — previously the one engine configuration without the
    guarantee."""
    rng = np.random.default_rng(99_000 + seed)
    panel_kw, args = _draw_config(rng)
    wi = args.index("--winsize")
    args[wi + 1] = str(int(rng.choice([25, 40, 70])))
    if "--lod-cutoff" not in args:
        args += ["--lod-cutoff", f"{rng.uniform(0.2, 2.0):.4f}"]
    args += ["--map", "f.map.gz", "--weighted",
             "--tpu-seed", str(seed)]  # same LD subsample both engines
    if rng.random() < 0.5:
        args += ["--ld-subsample", str(int(rng.integers(10, 25)))]
    if rng.random() < 0.3:
        args += ["--phased"]
    mesh = str(rng.choice(["2x4", "4x2", "8x1"]))
    panel = make_panel(**panel_kw)
    write_tped(panel, str(tmp_path / "f.tped.gz"), str(tmp_path / "f.tfam"))
    write_map_scaffold(panel, str(tmp_path / "f.map.gz"))
    wd = str(tmp_path)
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    rce = run_ours_subprocess(wd, args + ["--tpu-engine", "exact",
                                          "--out", "ex"])
    rcf = run_ours_subprocess(wd, args + ["--tpu-engine", "fast",
                                          "--tpu-mesh", mesh,
                                          "--out", "fa"], devices=8)
    assert rce == rcf
    if rce != 0:
        return
    a = open(os.path.join(wd, "ex.roh.bed")).read()
    b = open(os.path.join(wd, "fa.roh.bed")).read()
    assert a == b, ("mesh-weighted BED differs from exact", mesh, args)


@pytest.mark.slow
@pytest.mark.parametrize("seed",
                         _seed_range("GARLIC_FUZZ_STREAM_MESH_SEEDS", "0:2"))
def test_fuzz_mesh_streaming_identical_to_resident(tmp_path, seed,
                                                   monkeypatch):
    """Streaming composes with the mesh (round 4): when the window
    matrices exceed the mesh's AGGREGATE HBM budget, the LazyWin thunks
    rematerialize the SHARDED DeviceWin per chromosome — and the
    streamed mesh BED equals the resident mesh BED exactly."""
    rng = np.random.default_rng(44_000 + seed)
    panel_kw, args = _draw_config(rng)
    panel = make_panel(**panel_kw)
    wd = str(tmp_path)
    write_tped(panel, f"{wd}/f.tped.gz", f"{wd}/f.tfam")
    mesh = str(rng.choice(["2x4", "4x2"]))
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam",
            "--tpu-engine", "fast", "--tpu-mesh", mesh] + args
    rc1 = run_ours(wd, args + ["--out", "resident"])
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "1")
    rc2 = run_ours(wd, args + ["--out", "streamed"])
    assert (rc1 == 0) == (rc2 == 0), (args, rc1, rc2)
    if rc1 != 0:
        return
    a = read_text(os.path.join(wd, "resident.roh.bed"))
    b = read_text(os.path.join(wd, "streamed.roh.bed"))
    assert a == b, ("streamed mesh BED differs from resident", mesh, args)


@pytest.mark.slow
@pytest.mark.parametrize("seed",
                         _seed_range("GARLIC_FUZZ_WAUTO_SEEDS", "0:3"))
def test_fuzz_weighted_auto_cutoff(oracle_bin, tmp_path, seed):
    """Weighted AUTO-KDE cutoff vs the oracle (round 5): the fast
    engine's exact f64 wLOD Phase-II sampler must hold weighted
    auto-everything to the same three-part guarantee as plain runs —
    byte-identical .kde x column, and any BED divergence machine-verified
    as the oracle's own time-seeded FIGTree randomness.  Bounds stay
    pinned (auto-GMM aborts the oracle's GSL on many weighted length
    distributions, an oracle-side failure orthogonal to this class)."""
    import glob

    rng = np.random.default_rng(99_000 + seed)
    nind = int(rng.integers(22, 40))
    nchrom = int(rng.integers(1, 3))
    nloci = tuple(int(rng.integers(4000, 7000)) for _ in range(nchrom))
    panel_kw = dict(nind=nind, nloci_per_chr=nloci,
                    seed=int(rng.integers(0, 2**31)),
                    roh_rate=float(rng.uniform(0.25, 0.5)),
                    missing_rate=float(rng.uniform(0.0, 0.006)),
                    spacing_mean=int(rng.integers(2000, 4500)))
    winsize = int(rng.choice([25, 30, 40, 60]))
    args = ["--build", "hg18", "--winsize", str(winsize),
            "--error", f"{rng.uniform(5e-4, 3e-3):.6f}",
            "--kde-subsample", "0", "--ld-subsample", "0",
            "--map", "f.map.gz", "--weighted",
            "--size-bounds", "300000", "800000"]
    if rng.random() < 0.3:
        args += ["--phased"]
    gl_type = None
    if rng.random() < 0.3:
        gl_type = str(rng.choice(["GQ", "PL", "GL"]))
        args += ["--tgls", "f.tgls.gz", "--gl-type", gl_type]
    panel = make_panel(**panel_kw)
    wd = str(tmp_path)
    write_tped(panel, f"{wd}/f.tped.gz", f"{wd}/f.tfam")
    write_map_scaffold(panel, f"{wd}/f.map.gz")
    if gl_type is not None:
        write_tgls(panel, f"{wd}/f.tgls.gz", gl_type=gl_type,
                   seed=int(rng.integers(0, 2**31)))
    args = ["--tped", "f.tped.gz", "--tfam", "f.tfam"] + args
    r = run_oracle(oracle_bin, wd, args + ["--out", "oracle"])
    if r.returncode != 0 and "gsl" in r.stderr.lower():
        # oracle GSL abort (degenerate density/modes); ours must survive
        rc = run_ours_subprocess(
            wd, args + ["--tpu-engine", "fast", "--out", "ours"])
        assert rc in (0, 1, 2, 255), (args, rc)
        return
    assert r.returncode == 0, (args, r.stderr[-1500:])
    rc = run_ours_subprocess(
        wd, args + ["--tpu-engine", "fast", "--out", "ours"])
    # the x-grid guarantee holds regardless of the oracle's cutoff draw
    ka = sorted(glob.glob(os.path.join(wd, "oracle.*.kde")))
    kb = sorted(glob.glob(os.path.join(wd, "ours.*.kde")))
    assert len(ka) == 1 and len(kb) == 1, (args,)
    xa = [ln.split()[0] for ln in read_text(ka[0]).splitlines()
          if ln.strip()]
    xb = [ln.split()[0] for ln in read_text(kb[0]).splitlines()
          if ln.strip()]
    assert xa == xb, ("weighted .kde x column differs", args)
    ca = _selected_cutoff(read_text(os.path.join(wd, "oracle.log")))
    cb = _selected_cutoff(read_text(os.path.join(wd, "ours.log")))
    if ca != cb and ca is not None and cb is not None:
        _assert_randomized_oracle_class(wd, oracle_bin, args, ca, cb, rc)
        return
    assert rc == 0, (args, rc)
    a = read_text(os.path.join(wd, "oracle.roh.bed"))
    b = read_text(os.path.join(wd, "ours.roh.bed"))
    assert a == b, ("BED differs", args,
                    [(i, x, y) for i, (x, y) in enumerate(
                        zip(a.splitlines(), b.splitlines())) if x != y][:5])
