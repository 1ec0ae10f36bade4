#!/usr/bin/env python
"""GPU smoke run of the fast engine, end to end, at WGS panel scale.

    python chip_smoke.py          # one GPU: phases 1-5 below
    python chip_smoke.py --four   # four GPUs: the --tpu-mesh 4x1 / 2x2
                                  # runs and their single-device baseline

Everything runs in this one process (a JAX process reserves most of the
card's memory, so no second process may open it).  Engines are driven
through the CLI entry point `pipeline.run_main`, exactly as
`python -m garlic_tpu` would run them.  The panel is synthesized from a
seed (200 diploid individuals x 2 x 500k SNPs, seed 42, mean spacing
4 kb) into `.smoke_data/`, so nothing is downloaded.

Phases:
  1. synthesize the panel (and a 200 x 200k TGLS + genetic-map panel);
  2. pinned cutoff/bounds: default engine (must resolve to fast) vs
     exact — .roh.bed byte-identical; cold and warm walls;
  3. auto cutoff + auto bounds: BED identical, .kde x column identical,
     the device Gauss transform engaged, the device GMM engaged when the
     ROH count reaches its 4096 gate;
  4. TGLS GQ + --weighted --map + --ld-subsample 40 at 200 x 200k: BED
     identical;
  5. tie-band calibration: max |win_f32 - win_f64| / (eps32 * W * tmax)
     for W = 60/120/300 and TGLS; every ratio <= 64 (1/4 of the band).
     The fast engine's Phase I and coverage are XLA programs of f32 adds
     and selects (no matrix product, so TF32 plays no part); no
     hand-written kernel runs on this path.

The script fails (nonzero exit, no result line) when JAX finds no GPU;
it never falls back to the CPU.  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".smoke_data")
sys.path.insert(0, REPO)

NIND = 200
NLOCI = (500_000, 500_000)
TGLS_NLOCI = (200_000,)
SEED = 42
COMMON = ["--winsize", "60", "--error", "0.001", "--kde-subsample", "0",
          "--build", "hg18"]
PINNED = COMMON + ["--lod-cutoff", "1.5",
                   "--size-bounds", "500000", "1000000"]
WEIGHTED = COMMON + ["--tgls", "t.tgls.gz", "--gl-type", "GQ",
                     "--weighted", "--map", "t.map.gz",
                     "--ld-subsample", "40", "--tpu-seed", "1",
                     "--size-bounds", "500000", "1000000"]
BAND_LIMIT = 64.0       # a quarter of the tie patrol's 256 eps W tmax band
GMM_DEVICE_GATE = 4096  # ops.gmm.select_size_classes' device-EM gate


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[phase] {name}: start")
    yield
    log(f"[phase] {name}: ok ({time.perf_counter() - t0:.2f} s)")


def gpu_info() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def read(path: str) -> bytes:
    with open(os.path.join(DATA, path), "rb") as f:
        return f.read()


def run(args, out: str) -> float:
    """One CLI run (pipeline.run_main) in DATA; returns its wall time.
    The pipeline's stdout chatter is captured, not echoed."""
    from garlic_tpu.pipeline import run_main
    old = os.getcwd()
    os.chdir(DATA)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run_main(list(args) + ["--out", out], prog="garlic-tpu")
    finally:
        os.chdir(old)
    dt = time.perf_counter() - t0
    check(rc == 0, f"run {out} exited {rc}")
    return dt


class Spy:
    """Counts calls of module attributes while active."""

    def __init__(self, *targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))

            def wrap(*a, _orig=orig, _key=name, **k):
                self.calls[_key] = self.calls.get(_key, 0) + 1
                return _orig(*a, **k)

            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)

    def n(self, name: str) -> int:
        return self.calls.get(name, 0)


def synthesize(tgls: bool = True) -> None:
    from tests.util import (make_panel, write_map_scaffold, write_tgls,
                            write_tped)
    os.makedirs(DATA, exist_ok=True)
    if not os.path.exists(os.path.join(DATA, "p.tfam")):
        panel = make_panel(nind=NIND, nloci_per_chr=NLOCI, seed=SEED,
                           spacing_mean=4000)
        write_tped(panel, os.path.join(DATA, "p.tped.gz"),
                   os.path.join(DATA, "p.tfam"))
    if tgls and not os.path.exists(os.path.join(DATA, "t.tfam")):
        panel = make_panel(nind=NIND, nloci_per_chr=TGLS_NLOCI, seed=SEED,
                           spacing_mean=4000)
        write_tped(panel, os.path.join(DATA, "t.tped.gz"),
                   os.path.join(DATA, "t.tfam"))
        write_tgls(panel, os.path.join(DATA, "t.tgls.gz"), gl_type="GQ")
        write_map_scaffold(panel, os.path.join(DATA, "t.map.gz"))


def panel_args(tag: str):
    return ["--tped", f"{tag}.tped.gz", "--tfam", f"{tag}.tfam"]


def roh_count(bed: bytes) -> int:
    return sum(1 for ln in bed.splitlines()
               if ln and not ln.startswith(b"track"))


def phase_pinned() -> None:
    from garlic_tpu import pipeline
    from garlic_tpu.ops import device_win
    check(pipeline._resolve_engine("auto") == "fast",
          "--tpu-engine auto did not resolve to fast on this GPU")
    with Spy((device_win, "covered_dispatch")) as spy:
        cold = run(panel_args("p") + PINNED, "pin_fast")
        warm = run(panel_args("p") + PINNED, "pin_fast2")
    check(spy.n("covered_dispatch") > 0, "default run took no device path")
    t_exact = run(panel_args("p") + PINNED + ["--tpu-engine", "exact"],
                  "pin_exact")
    bed = read("pin_fast.roh.bed")
    check(bed == read("pin_exact.roh.bed"), "pinned BED: fast != exact")
    check(bed == read("pin_fast2.roh.bed"), "pinned BED: warm != cold")
    log(f"  pinned: {roh_count(bed)} ROH; fast cold {cold:.3f} s, "
        f"fast warm {warm:.3f} s, exact {t_exact:.3f} s")


def phase_auto() -> None:
    from garlic_tpu.ops import gmm, kde
    from garlic_tpu.parallel import engine
    with Spy((kde, "_gauss_wins_factory"), (kde, "_device_gauss_block"),
             (kde, "_kde_flat_factory"), (gmm, "_device_mesh_1x1"),
             (engine, "fit_gmm_sharded")) as spy:
        t_fast = run(panel_args("p") + COMMON, "auto_fast")
    t_exact = run(panel_args("p") + COMMON + ["--tpu-engine", "exact"],
                  "auto_exact")
    bed = read("auto_fast.roh.bed")
    check(bed == read("auto_exact.roh.bed"), "auto BED: fast != exact")

    def xcol(name):
        return [ln.split()[0] for ln in read(name).splitlines() if ln.strip()]

    check(xcol("auto_fast.60SNPs.kde") == xcol("auto_exact.60SNPs.kde"),
          ".kde x column: fast != exact")
    gauss = (spy.n("_gauss_wins_factory") + spy.n("_device_gauss_block")
             + spy.n("_kde_flat_factory"))
    check(gauss > 0, "the device Gauss transform did not run")
    n = roh_count(bed)
    gmm_dev = spy.n("fit_gmm_sharded") > 0
    if n >= GMM_DEVICE_GATE:
        check(gmm_dev, f"{n} ROH >= {GMM_DEVICE_GATE} but the device GMM "
              "did not run")
    log(f"  auto: {n} ROH; device Gauss transform calls {gauss}; device "
        f"GMM {'ran' if gmm_dev else 'not engaged (below gate)'}; fast "
        f"{t_fast:.3f} s, exact {t_exact:.3f} s")


def phase_weighted() -> None:
    t_fast = run(panel_args("t") + WEIGHTED, "w_fast")
    t_exact = run(panel_args("t") + WEIGHTED + ["--tpu-engine", "exact"],
                  "w_exact")
    bed = read("w_fast.roh.bed")
    check(bed == read("w_exact.roh.bed"), "TGLS weighted BED: fast != exact")
    log(f"  TGLS weighted: {roh_count(bed)} ROH; fast {t_fast:.3f} s, "
        f"exact {t_exact:.3f} s")


def _load(tag: str, tgls: bool):
    from garlic_tpu import api
    return api.load_panel(os.path.join(DATA, f"{tag}.tped.gz"),
                          os.path.join(DATA, f"{tag}.tfam"),
                          tgls=os.path.join(DATA, "t.tgls.gz") if tgls
                          else None, build="hg18")


def band_ratio(chrom, centro, W: int, use_gl: bool) -> float:
    from garlic_tpu.core.types import MISSING
    from garlic_tpu.ops import device_win, lod
    from garlic_tpu.pipeline import _corner_tmax
    fast = device_win.lod_windows_device(chrom, centro, W, 0.001, 200000,
                                         use_gl).to_numpy()
    exact = lod.calc_lod_windows(chrom, centro, W, 0.001, 200000, use_gl,
                                 engine="exact")
    live = exact != MISSING
    check(np.array_equal(live, fast != MISSING), "MISSING layout differs")
    tmax = _corner_tmax(chrom, 0.001, use_gl)
    err = float(np.max(np.abs(fast[live] - exact[live])))
    return err / (2.0 ** -23 * W * tmax)


def phase_band(centro, chrom) -> None:
    ratios = {}
    for W in (60, 120, 300):
        ratios[f"W={W}"] = band_ratio(chrom, centro, W, False)
    ds_t = _load("t", True)
    ratios["TGLS W=60"] = band_ratio(ds_t.chroms[0], centro, 60, True)
    for k, r in ratios.items():
        log(f"  tie-band ratio {k}: {r:.4f}")
    bad = {k: r for k, r in ratios.items() if not r <= BAND_LIMIT}
    check(not bad, f"tie-band ratio above {BAND_LIMIT}: {bad}")


def memory_report(centro, chrom) -> None:
    from garlic_tpu.ops import device_win, lod
    missing = lod.window_missing_mask(chrom.positions, 60, 200000,
                                      centro.start(chrom.chrom),
                                      centro.end(chrom.chrom))
    inputs = device_win._phase1_inputs(chrom, 60, missing, 0.001)
    compiled = device_win._packed_windows.lower(*inputs, 60).compile()
    log(f"  Phase-I program memory_analysis: {compiled.memory_analysis()}")


def single_card() -> None:
    from garlic_tpu.centromeres import Centromere
    from garlic_tpu.logger import RunLog
    centro = Centromere("hg18", "none", "none", RunLog())
    with phase("1 synthesize panel"):
        synthesize()
    with phase("2 pinned run, default engine vs exact"):
        phase_pinned()
        chrom = _load("p", False).chroms[0]
        memory_report(centro, chrom)
    with phase("3 auto cutoff + auto bounds vs exact"):
        phase_auto()
    with phase("4 TGLS GQ weighted --ld-subsample 40 vs exact"):
        phase_weighted()
    with phase("5 tie-band calibration"):
        phase_band(centro, chrom)


def four_cards() -> None:
    import jax

    from garlic_tpu.parallel import engine
    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, have "
          f"{len(jax.devices())}")
    with phase("1 synthesize panel"):
        synthesize(tgls=False)
    for name, flags in (("pin", PINNED), ("auto", COMMON)):
        with phase(f"{name}: single device vs --tpu-mesh 4x1 and 2x2"):
            t1 = run(panel_args("p") + flags, f"{name}_one")
            ref = read(f"{name}_one.roh.bed")
            for mesh in ("4x1", "2x2"):
                seen = []
                orig = engine.lod_windows_sharded

                def spy(*a, **k):
                    out = orig(*a, **k)
                    seen.append(len(out.win.sharding.device_set))
                    return out

                engine.lod_windows_sharded = spy
                try:
                    t = run(panel_args("p") + flags + ["--tpu-mesh", mesh],
                            f"{name}_{mesh}")
                finally:
                    engine.lod_windows_sharded = orig
                check(seen and min(seen) == 4,
                      f"{mesh}: window shards span {seen} devices, not 4")
                check(read(f"{name}_{mesh}.roh.bed") == ref,
                      f"{name} BED: mesh {mesh} != single device")
                log(f"  {name} {mesh}: BED identical to single device "
                    f"({roh_count(ref)} ROH); {t:.3f} s vs {t1:.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    log(f"gpu: {gpu_info()}")
    log(f"jax {jax.__version__}; devices: "
        f"{[d.device_kind for d in devs]}")
    try:
        from garlic_tpu.native import native_available
        check(native_available(), "the native host library did not build "
              "(g++ and zlib headers are required)")
        four_cards() if args.four else single_card()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
