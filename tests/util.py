"""Shared test utilities: synthetic panel generation and oracle harness.

The reference ships no test inputs (example blobs stripped), so panels are
synthesized with planted autozygous segments to give the LOD distribution its
two modes, then outputs are diffed against the runnable oracle binary.
"""

from __future__ import annotations

import gzip
import os
import subprocess
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Panel:
    chrom_names: List[str]
    positions: List[np.ndarray]       # per chr
    freq: List[np.ndarray]            # per chr, truth freqs used to simulate
    genotypes: List[np.ndarray]       # per chr [I, L] 0/1/2/-9
    ind_ids: List[str]
    pop: str = "POP1"


def make_panel(nind=30, nloci_per_chr=(4000, 3000), seed=7,
               roh_rate=0.35, missing_rate=0.002, chrom_names=None,
               big_gap_every=0, spacing_mean=3000) -> Panel:
    """Synthesize a diploid panel with planted ROH segments."""
    rng = np.random.default_rng(seed)
    if chrom_names is None:
        chrom_names = [f"{i+1}" for i in range(len(nloci_per_chr))]
    positions, freqs, genos = [], [], []
    for ci, L in enumerate(nloci_per_chr):
        gaps = rng.integers(100, spacing_mean * 2, size=L)
        if big_gap_every:
            idx = np.arange(big_gap_every, L, big_gap_every)
            gaps[idx] = 300000 + rng.integers(0, 100000, size=idx.shape[0])
        pos = 100000 + np.cumsum(gaps)
        f = rng.beta(0.8, 0.8, size=L)
        f = np.clip(f, 0.02, 0.98)
        g = np.empty((nind, L), dtype=np.int8)
        for i in range(nind):
            a1 = rng.random(L) < f
            a2 = rng.random(L) < f
            gi = (a1.astype(np.int8) + a2.astype(np.int8))
            # plant autozygous stretches: both alleles identical by descent
            ptr = 0
            while ptr < L:
                if rng.random() < roh_rate * 0.01:
                    seg = int(rng.integers(150, 600))
                    a = rng.random(min(seg, L - ptr)) < f[ptr:ptr + seg]
                    gi[ptr:ptr + seg] = 2 * a.astype(np.int8)
                    ptr += seg
                else:
                    ptr += int(rng.integers(50, 200))
            g[i] = gi
        miss = rng.random((nind, L)) < missing_rate
        g[miss] = -9
        positions.append(pos.astype(np.int64))
        freqs.append(f)
        genos.append(g)
    ind_ids = [f"IND{i:04d}" for i in range(nind)]
    return Panel(chrom_names=chrom_names, positions=positions, freq=freqs,
                 genotypes=genos, ind_ids=ind_ids)


def write_tped(panel: Panel, tped_path: str, tfam_path: str,
               gpos: Optional[List[np.ndarray]] = None,
               missing_char: str = "0") -> None:
    """Write TPED/TFAM. Allele 'A' = alt (counted), 'C' = ref,
    `missing_char` missing (pair with --tped-missing when not '0').

    Vectorized: the genotype columns are rendered as one fixed-width byte
    matrix per chromosome (4 chars per diploid genotype: ' x y') so
    WGS-scale panels write in seconds, not minutes."""
    # genotype code -> 4 ASCII bytes " a b"; index 3 = missing (-9)
    m = missing_char.encode()
    lut = np.array([b" C C", b" A C", b" A A",
                    b" " + m + b" " + m], dtype="S4")
    if tped_path.endswith(".gz"):
        # level 1: WGS-scale panels are ~1 GB of text; level 9 takes tens
        # of minutes for no benefit to the consumer
        def op(p, m):
            return gzip.open(p, m, compresslevel=1)
    else:
        op = open
    with op(tped_path, "wb") as f:
        for ci, chrom in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            g = panel.genotypes[ci]
            gp = gpos[ci] if gpos is not None else np.zeros(len(pos))
            L = len(pos)
            codes = np.where(g == -9, 3, g).astype(np.uint8)     # [I, L]
            cells = np.ascontiguousarray(lut[codes.T])            # [L, I] S4
            geno_part = cells.view("S1").reshape(L, -1)           # [L, 4I]
            geno_rows = geno_part.view(f"S{geno_part.shape[1]}")[:, 0]
            for start in range(0, L, 65536):
                stop = min(start + 65536, L)
                chunk = []
                for l in range(start, stop):
                    chunk.append(
                        f"{chrom} rs{ci}_{l} {gp[l]:g} {int(pos[l])}"
                        .encode() + geno_rows[l] + b"\n")
                f.write(b"".join(chunk))
    with open(tfam_path, "w") as f:
        for ind in panel.ind_ids:
            f.write(f"{panel.pop} {ind} 0 0 0 -9\n")


def write_tgls(panel: Panel, path: str, gl_type: str = "GQ",
               seed: int = 5) -> None:
    """Write a TGLS likelihood file aligned with the panel's TPED rows
    (4 leading columns + one value per individual,
    src/garlic-data.cpp:1516-1586)."""
    rng = np.random.default_rng(seed)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for ci, chrom in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            for l in range(len(pos)):
                if gl_type == "GQ":
                    vals = rng.integers(20, 60, size=len(panel.ind_ids))
                elif gl_type == "PL":
                    vals = rng.integers(0, 40, size=len(panel.ind_ids))
                else:  # GL: log10 P(right)
                    vals = -rng.random(len(panel.ind_ids)) * 0.01
                f.write(f"{chrom} rs{ci}_{l} 0 {int(pos[l])} "
                        + " ".join(str(v) for v in vals) + "\n")


def write_map_scaffold(panel: Panel, path: str, rate_cm_per_mb=1.2) -> List[np.ndarray]:
    """Write a 4-col genetic map scaffold covering each chromosome with a
    coarse grid; returns per-chr true gpos at data sites (approx)."""
    op = gzip.open if path.endswith(".gz") else open
    out = []
    with op(path, "wt") as f:
        for ci, chrom in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            lo, hi = int(pos[0]) - 1000, int(pos[-1]) + 1000
            grid = np.unique(np.linspace(lo, hi, 200).astype(np.int64))
            gp = (grid - grid[0]) * rate_cm_per_mb / 1e6 * 100
            for x, g in zip(grid, gp):
                f.write(f"{chrom} map{ci}_{x} {g:.8f} {x}\n")
            out.append(None)
    return out


def run_oracle(oracle_bin: str, workdir: str, args: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run([oracle_bin] + args, cwd=workdir,
                          capture_output=True, text=True, timeout=600)


def run_ours(workdir: str, args: List[str]) -> int:
    """Run our pipeline in-process inside workdir."""
    from garlic_tpu.pipeline import run_main
    old = os.getcwd()
    os.chdir(workdir)
    try:
        return run_main(args, prog="garlic")
    finally:
        os.chdir(old)


def read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def diff_logs(log_a: str, log_b: str, base_a: str = "oracle",
              base_b: str = "ours") -> List[str]:
    """Compare .log files ignoring the first (command) line and normalizing
    the output basenames."""
    a = [l.replace(base_a, "BASE") for l in log_a.splitlines()[1:]]
    b = [l.replace(base_b, "BASE") for l in log_b.splitlines()[1:]]
    diffs = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            diffs.append(f"line {i+2}: {x!r} != {y!r}")
    if len(a) != len(b):
        diffs.append(f"length {len(a)} != {len(b)}")
    return diffs


def oracle_cutoff_reachable(kde: "np.ndarray", wsize: int,
                            oracle_cutoff: str, ours_cutoff: str) -> bool:
    """Is the oracle's auto-cutoff draw reachable at the FIGTree error
    scale from our exact density?  Two calibrated criteria (round 5 —
    replaces the old min/max-span fallback, which on wide valleys
    accepted nearly anything):

      1. EXACT probe-rival membership: the seeded perturbation probe
         (ops.cutoff.cutoff_tie_probe) produced the oracle's value at a
         grid point, %g-equal;
      2. deterministic valley reachability: the oracle's cutoff is one
         of OUR grid points, lies between our located modes, and its
         density is within 2x the measured FIGTree absolute-error bound
         (FIGTREE_ABS_ERR * ymax) of the valley minimum — i.e. some
         error draw within the measured envelope makes it the argmin of
         the quirk-faithful between-modes scan.  This is exact where the
         probe is sampled: the K random draws can miss a reachable
         point, but no point OUTSIDE the error bound is ever accepted.

    The oracle's 0.0 sanity-clamp case (|x/winsize| >= 1,
    src/garlic-kde.cpp:231-232) is accepted when any
    valley-reachable grid point triggers the clamp."""
    import numpy as np

    from garlic_tpu.ops.cutoff import (FIGTREE_ABS_ERR, CutoffError,
                                       cutoff_tie_probe,
                                       get_min_btw_modes_indices)
    x, y = kde[:, 0], kde[:, 1]
    alts = cutoff_tie_probe(x, y, wsize)
    if any("%g" % a == oracle_cutoff for a in alts):
        return True
    try:
        _, li, ri, _ = get_min_btw_modes_indices(x, y, wsize)
    except CutoffError:
        return False
    ymax = float(np.max(y))
    err = 2.0 * FIGTREE_ABS_ERR * ymax
    # Mode-structure stability under FIGTree's zero truncation: FIGTree
    # drops cluster contributions below its truncation radius to EXACT
    # ZERO with a spatially varying threshold, and get_min_btw_modes'
    # run-length counting branches on exact equality — so on densities
    # with wide near-zero regions the located modes themselves move
    # wholesale between draws (observed: modes (381,488) on exact y vs
    # (24,46) on the oracle's).  When any global-threshold truncation
    # relocates a mode beyond the finder's own 20-point window, every
    # grid point inside the error bound of zero is reachable; when the
    # structure is stable, only valley points within the bound of the
    # valley minimum are.
    unstable = False
    for t in (1e-300, 1e-16, 1e-13, 1e-10, 1e-8, 1e-6, 1e-4, 1e-3):
        yt = np.where(y <= t * ymax, 0.0, y)
        try:
            _, li2, ri2, _ = get_min_btw_modes_indices(x, yt, wsize)
        except CutoffError:
            unstable = True
            continue
        if abs(li2 - li) > 20 or abs(ri2 - ri) > 20:
            unstable = True
    # Shallow-valley instability: when the dip between the located modes
    # is itself within the FIGTree error envelope, the mode PAIR is a
    # draw artifact — FIGTree's spatially correlated error can relocate
    # a mode wholesale and the between-modes argmin then lands in a
    # completely different low-density region.  (Empirical: one fuzz
    # density with a 0.4%-deep valley drew 4 distinct oracle cutoffs
    # spanning 290 grid points across 5 back-to-back runs.)
    vmin_valley = float(np.min(y[li:ri + 1]))
    if min(float(y[li]), float(y[ri])) - vmin_valley <= err:
        unstable = True
    # valley points within the error of the valley floor are always
    # reachable; instability ADDS every low-density grid point (2x the
    # usual bound: the correlated cluster-wise error is bounded
    # per-region, not per-point)
    reach = np.flatnonzero(y[li:ri + 1] <= vmin_valley + err) + li
    if unstable:
        reach = np.union1d(reach, np.flatnonzero(y <= 2.0 * err))
    if oracle_cutoff == "0":
        # the clamp fires when the selected grid point's |x/wsize| >= 1
        return bool(np.any(np.abs(x[reach] / wsize) >= 1))
    io = [i for i in reach if "%g" % x[i] == oracle_cutoff]
    return bool(io)


def assert_bed_same_or_oracle_random(oracle_bin: str, wd: str,
                                     args: List[str], oracle_out: str,
                                     ours_out: str, winsize: int) -> None:
    """Assert ours.roh.bed == oracle.roh.bed, accepting ONLY the
    documented randomized-oracle class when they differ.

    The reference's auto-KDE Phase II is randomized run-to-run: FIGTree's
    KCenterClustering::Cluster seeds rand() with time(NULL) (verified by
    disassembly), so on densities with near-tie valleys the ORACLE ITSELF
    selects different cutoffs on different runs — no deterministic
    implementation can match every draw.  A BED mismatch is accepted only
    when ALL of:

      1. the .kde x columns are byte-identical (our bandwidth/grid math
         is bit-exact; only the FIGTree-approximated y differs);
      2. our quirk-faithful tie probe flags the oracle's selected cutoff
         as reachable at the FIGTree error scale (or the cutoffs agree
         and the diff came from near-cutoff y wobble on equal cutoffs —
         rejected: equal cutoffs must give equal BEDs);
      3. re-running the oracle with OUR cutoff pinned via --lod-cutoff
         reproduces our BED byte-for-byte (everything downstream of the
         randomized selection is exact).
    """
    import re

    a = read_text(os.path.join(wd, oracle_out + ".roh.bed"))
    b = read_text(os.path.join(wd, ours_out + ".roh.bed"))
    if a == b:
        return
    kde_sfx = f".{winsize}SNPs.kde"
    ka = read_text(os.path.join(wd, oracle_out + kde_sfx))
    kb = read_text(os.path.join(wd, ours_out + kde_sfx))
    xa = [line.split()[0] for line in ka.splitlines() if line.strip()]
    xb = [line.split()[0] for line in kb.splitlines() if line.strip()]
    assert xa == xb, ".roh.bed differs AND the .kde x columns differ — " \
        "not the randomized-oracle class; a real bug"
    log_a = read_text(os.path.join(wd, oracle_out + ".log"))
    log_b = read_text(os.path.join(wd, ours_out + ".log"))
    pat = re.compile(r"Selected LOD score cutoff: (\S+)")
    ca, cb = pat.search(log_a), pat.search(log_b)
    assert ca and cb, "BED differs on a non-auto-cutoff run"
    assert ca.group(1) != cb.group(1), \
        ".roh.bed differs with EQUAL cutoffs %s — not the randomized-" \
        "oracle class; a real bug" % ca.group(1)
    # the oracle's draw must be reachable at the FIGTree error scale —
    # or the oracle must demonstrably not reproduce itself on this
    # density (time-seeded re-draws differ; the pinned-cutoff BED
    # reproduction below still carries the correctness proof)
    import numpy as np
    kde = np.loadtxt(os.path.join(wd, ours_out + kde_sfx))
    if not oracle_cutoff_reachable(kde, winsize, ca.group(1),
                                   cb.group(1)):
        import time as _time
        redraws = set()
        for _ in range(3):
            _time.sleep(1.1)
            r = run_oracle(oracle_bin, wd, args + ["--out",
                                                   oracle_out + "_rr"])
            if r.returncode == 0:
                m = pat.search(read_text(
                    os.path.join(wd, oracle_out + "_rr.log")))
                if m:
                    redraws.add(m.group(1))
        assert len(redraws - {ca.group(1)}) > 0, \
            "oracle cutoff %s not FIGTree-reachable from ours %s AND " \
            "reproduced across re-runs — a real bug" \
            % (ca.group(1), cb.group(1))
    # with our cutoff (and winsize: the auto search is randomized too)
    # pinned, the oracle must reproduce our BED exactly
    pinned, i = [], 0
    while i < len(args):
        tok = args[i]
        if tok in ("--winsize", "--auto-winsize-step"):
            i += 2
            continue
        if tok == "--auto-winsize":
            i += 1
            continue
        if tok == "--winsize-multi":  # swallow the integer list
            i += 1
            while i < len(args) and args[i].isdigit():
                i += 1
            continue
        pinned.append(tok)
        i += 1
    pinned += ["--winsize", str(winsize),
               "--lod-cutoff", cb.group(1), "--out", oracle_out + "_pin"]
    r = run_oracle(oracle_bin, wd, pinned)
    assert r.returncode == 0, r.stderr[-2000:]
    pb = read_text(os.path.join(wd, oracle_out + "_pin.roh.bed"))
    assert pb == b, "oracle(pinned to our cutoff) BED still differs — " \
        "a real bug beyond the randomized cutoff selection"


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ours_subprocess(workdir: str, args: List[str],
                        devices: int = 1) -> int:
    """Run our pipeline as a fresh CPU subprocess.

    Long in-process campaigns eventually segfault inside XLA's CPU
    compiler/serializer after ~30 large compilations (LLVM JIT state —
    observed in fuzz runs; not reachable from a single pipeline run), so
    campaign-style tests isolate each invocation; the -c driver pins the
    subprocess to the CPU backend.
    devices > 1: give the subprocess that many virtual CPU devices
    (--tpu-mesh runs)."""
    import sys as _sys
    driver = ("import sys, os; "
              "os.environ['XLA_FLAGS'] = "
              "'--xla_force_host_platform_device_count=%d'; "
              "import jax; jax.config.update('jax_platforms', 'cpu'); "
              "sys.path.insert(0, %r); "
              "from garlic_tpu.pipeline import run_main; "
              "sys.exit(run_main(sys.argv[1:], prog='garlic'))"
              % (devices, REPO))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([_sys.executable, "-c", driver] + args, cwd=workdir,
                       env=env, capture_output=True, text=True, timeout=900)
    return r.returncode
