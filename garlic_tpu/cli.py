"""Command-line flag registry, parser and semantic validators.

Reimplements the reference's typed flag system (`param_t`,
src/param_t.{h,cpp}) and the GARLIC flag schema + ~20 cross-flag validators
(src/garlic-cli.cpp).  Parsing semantics match the reference:

* bool flags toggle their default when present (src/param_t.cpp:279-281)
* scalar flags consume exactly one following token, validated as int/double/
  char (src/param_t.cpp:283-301)
* list flags consume tokens until the next known flag (src/param_t.cpp:303-341)
* duplicate or unknown flags are rejected (src/param_t.cpp:272-277,520-527)

Extra flags not present in the reference are namespaced under --tpu-* (a
historical prefix kept for compatibility) and control the device engine
(mesh shape, precision, device usage).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .core.fmt import g
from .version import OUTPUT_COMPAT_VERSION

VERSION = OUTPUT_COMPAT_VERSION

PREAMBLE = f"""
garlic-tpu v{VERSION} -- a device-accelerated engine to call runs of homozygosity in genetic data.

Citations:

A Blant, et al. (2017) bioRxiv, doi: 10.1101/177352
ZA Szpiech, et al. (2017) Bioinformatics, doi: 10.1093/bioinformatics/btx102
TJ Pemberton, et al. (2012) AJHG, 91: 275-292
"""

# ---------------------------------------------------------------------------
# Flag names and defaults (reference: src/garlic-cli.cpp:15-174)
# ---------------------------------------------------------------------------
ARG_OVERLAP_FRAC = "--overlap-frac"
ARG_AUTO_OVERLAP_FRAC = "--auto-overlap-frac"
ARG_OUTFILE = "--out"
ARG_THREADS = "--threads"
ARG_ERROR = "--error"
ARG_WINSIZE = "--winsize"
ARG_WINSIZE_MULTI = "--winsize-multi"
ARG_AUTO_WINSIZE = "--auto-winsize"
ARG_AUTO_WINSIZE_STEP = "--auto-winsize-step"
ARG_MAX_GAP = "--max-gap"
ARG_RESAMPLE = "--resample"
ARG_TPED = "--tped"
ARG_TFAM = "--tfam"
ARG_TGLS = "--tgls"
ARG_GL_TYPE = "--gl-type"
ARG_MAP = "--map"
ARG_WEIGHTED = "--weighted"
ARG_RAW_LOD = "--raw-lod"
ARG_LOD_CUTOFF = "--lod-cutoff"
ARG_BOUND_SIZE = "--size-bounds"
ARG_TPED_MISSING = "--tped-missing"
ARG_FREQ_FILE = "--freq-file"
ARG_FREQ_ONLY = "--freq-only"
ARG_KDE_SUBSAMPLE = "--kde-subsample"
ARG_LD_SUBSAMPLE = "--ld-subsample"
ARG_BUILD = "--build"
ARG_CENTROMERE_FILE = "--centromere"
ARG_M = "--M"
ARG_MU = "--mu"
ARG_PHASED = "--phased"
ARG_NCLUST = "--nclust"
ARG_CM = "--cm"
ARG_KDE_THINNING = "--no-kde-thinning"
# Device-engine extensions (not in reference)
ARG_ENGINE = "--tpu-engine"
ARG_SEED = "--tpu-seed"
ARG_PROFILE = "--tpu-profile"
ARG_MESH = "--tpu-mesh"
ARG_PANEL_CACHE = "--tpu-panel-cache"

DEFAULT_OUTFILE = "outfile"
DEFAULT_TPED = "none"
DEFAULT_TFAM = "none"
DEFAULT_TGLS = "none"
DEFAULT_GL_TYPE = "none"
DEFAULT_MAP = "none"
DEFAULT_FREQ_FILE = "none"
DEFAULT_BUILD = "none"
DEFAULT_CENTROMERE_FILE = "none"
DEFAULT_LOD_CUTOFF = -999999.0
DEFAULT_BOUND_SIZE = -1.0
DEFAULT_WINSIZE_MULTI = -1


@dataclass
class FlagSpec:
    name: str
    kind: str          # bool,int,double,char,string,list-int,list-double
    default: object
    help: str


@dataclass
class ParsedArgs:
    values: Dict[str, object] = field(default_factory=dict)

    def __getitem__(self, k):
        return self.values[k]


def _flag_specs() -> List[FlagSpec]:
    return [
        FlagSpec(ARG_OVERLAP_FRAC, "double", 0.25,
                 "The minimum fraction of overlapping windows above the LOD cutoff required\n"
                 "\tto begin constructing a run."),
        FlagSpec(ARG_AUTO_OVERLAP_FRAC, "bool", False,
                 "If set, GARLIC attempts to guess based on marker density."),
        FlagSpec(ARG_OUTFILE, "string", DEFAULT_OUTFILE, "The base name for all output files."),
        FlagSpec(ARG_THREADS, "int", 1,
                 "The number of host threads for native I/O and weighted calculations."),
        FlagSpec(ARG_ERROR, "double", -1.0, "The assumed genotyping error rate."),
        FlagSpec(ARG_WINSIZE, "int", 0,
                 "The window size in # of SNPs in which to calculate LOD scores."),
        FlagSpec(ARG_MAX_GAP, "int", 200000,
                 "A LOD score window is not calculated if the gap (in bps)\n"
                 "\tbetween two loci is greater than this value."),
        FlagSpec(ARG_RESAMPLE, "int", 0,
                 "Number of resamples for estimating allele frequencies."),
        FlagSpec(ARG_TPED, "string", DEFAULT_TPED,
                 "A tped formatted file containing map and genotype information."),
        FlagSpec(ARG_TFAM, "string", DEFAULT_TFAM,
                 "A tfam formatted file containing population and individual IDs."),
        FlagSpec(ARG_TGLS, "string", DEFAULT_TGLS,
                 "A tgls file containing per-genotype likelihoods."),
        FlagSpec(ARG_GL_TYPE, "string", DEFAULT_GL_TYPE,
                 "Specify the form of the genotype likelihood data: GQ, GL, or PL."),
        FlagSpec(ARG_MAP, "string", DEFAULT_MAP,
                 "Provide a scaffold genetic map; absent sites are interpolated."),
        FlagSpec(ARG_WEIGHTED, "bool", False,
                 "Compute LOD scores weighted by LD and probability of mutation."),
        FlagSpec(ARG_RAW_LOD, "bool", False,
                 "If set, LOD scores will be output to gzip compressed files."),
        FlagSpec(ARG_BOUND_SIZE, "list-double", [DEFAULT_BOUND_SIZE],
                 "Specify the size class boundaries. Must be increasing."),
        FlagSpec(ARG_LOD_CUTOFF, "double", DEFAULT_LOD_CUTOFF,
                 "Specify a single LOD score cutoff above which ROH are called."),
        FlagSpec(ARG_TPED_MISSING, "char", "0",
                 "Single character missing data code for TPED files."),
        FlagSpec(ARG_FREQ_FILE, "string", DEFAULT_FREQ_FILE,
                 "A file specifying allele frequencies for all variants."),
        FlagSpec(ARG_FREQ_ONLY, "bool", False,
                 "If set, calculates a freq file from provided data and then exits."),
        FlagSpec(ARG_WINSIZE_MULTI, "list-int", [DEFAULT_WINSIZE_MULTI],
                 "Provide several window sizes (in # of SNPs) to calculate LOD scores."),
        FlagSpec(ARG_KDE_SUBSAMPLE, "int", 20,
                 "The number of individuals to randomly sample for LOD score KDE."),
        FlagSpec(ARG_LD_SUBSAMPLE, "int", 0,
                 "The number of individuals to randomly sample for LD during wLOD."),
        FlagSpec(ARG_AUTO_WINSIZE, "bool", False,
                 "Automatically select the LOD window size."),
        FlagSpec(ARG_AUTO_WINSIZE_STEP, "int", 10,
                 "Step size for automatic window selection algorithm."),
        FlagSpec(ARG_BUILD, "string", DEFAULT_BUILD,
                 "Genome build for centromere locations (hg18, hg19, or hg38)."),
        FlagSpec(ARG_CENTROMERE_FILE, "string", DEFAULT_CENTROMERE_FILE,
                 "Provide custom centromere boundaries. Format <chr> <start> <end>."),
        FlagSpec(ARG_M, "int", 7,
                 "Expected number of meioses since a recent common ancestor (--weighted)."),
        FlagSpec(ARG_MU, "double", 1e-9,
                 "Mutation rate per bp per generation for --weighted calculation."),
        FlagSpec(ARG_PHASED, "bool", False,
                 "Set if data are phased; uses r2 instead of hr2 when --weighted is set."),
        FlagSpec(ARG_NCLUST, "int", 3,
                 "Number of clusters for GMM classification of ROH lengths."),
        FlagSpec(ARG_CM, "bool", False,
                 "Measure ROH lengths in genetic distance units. Requires a mapfile."),
        FlagSpec(ARG_KDE_THINNING, "bool", False,
                 "Send all LOD score data to the KDE (may dramatically increase runtime)."),
        FlagSpec(ARG_ENGINE, "string", "auto",
                 "Compute engine: exact (f64, byte-identical to GARLIC), fast (device f32; auto picks it on a GPU), auto."),
        FlagSpec(ARG_SEED, "int", -1,
                 "RNG seed for subsampling/resampling; -1 uses a time-based seed "
                 "(matching the reference's non-reproducible default)."),
        FlagSpec(ARG_PROFILE, "bool", False,
                 "Print per-phase wall-clock and throughput counters to stderr; "
                 "set GARLIC_TPU_TRACE_DIR to also capture a JAX profiler trace."),
        FlagSpec(ARG_MESH, "string", "none",
                 "Device mesh 'DPxSP' for the fast engine (e.g. 4x2: individuals "
                 "sharded over 4 ways, loci over 2 with halo exchange), or "
                 "'auto' to factor all visible devices. "
                 "Requires DP*SP visible devices; default single-device."),
        FlagSpec(ARG_PANEL_CACHE, "bool", False,
                 "Write/reuse a binary panel sidecar (<tped>.gtpc) to skip "
                 "TPED re-parsing on repeated runs of the same panel."),
    ]


class CLIError(Exception):
    pass


def _good_int(s: str) -> bool:
    # reference: src/param_t.cpp:247-258 (digits and a leading '-')
    if not s:
        return False
    for i, c in enumerate(s):
        if c == "-" and i == 0:
            continue
        if not c.isdigit():
            return False
    return True


def _good_double(s: str) -> bool:
    # reference: src/param_t.cpp:232-245 (digits, one '.', leading '-')
    if not s:
        return False
    ndec = 0
    for i, c in enumerate(s):
        if c == ".":
            ndec += 1
            if ndec > 1:
                return False
        elif c == "-":
            if i != 0:
                return False
        elif not c.isdigit():
            return False
    return True


def parse_command_line(argv: List[str]) -> Optional[ParsedArgs]:
    """Parse argv (without program name). Returns None if --help was given.

    Raises CLIError on malformed input (reference exits with an error message;
    the caller converts the exception to exit status)."""
    specs = {s.name: s for s in _flag_specs()}
    values: Dict[str, object] = {s.name: s.default for s in specs.values()}
    seen: set[str] = set()

    if "--help" in argv:
        print(PREAMBLE)
        for s in sorted(specs.values(), key=lambda s: s.name):
            kind = {"bool": "<bool>", "int": "<int>", "double": "<double>",
                    "char": "<char>", "string": "<string>",
                    "list-int": "<int1> ... <intN>",
                    "list-double": "<double1> ... <doubleN>"}[s.kind]
            dflt = s.default
            if isinstance(dflt, list):
                dflt = " ".join(g(v) if isinstance(v, float) else str(v) for v in dflt)
            elif isinstance(dflt, bool):
                dflt = "true" if dflt else "false"
            elif isinstance(dflt, float):
                dflt = g(dflt)
            print(f"{s.name} {kind}: {s.help}\n\tDefault: {dflt}\n")
        return None

    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in seen:
            raise CLIError(f"ERROR: Duplicate {tok} found.")
        if tok not in specs:
            raise CLIError(f"ERROR: command line flag {tok} not recognized.")
        spec = specs[tok]
        seen.add(tok)
        if spec.kind == "bool":
            values[tok] = not spec.default
            i += 1
        elif spec.kind in ("int", "double", "char", "string"):
            if i + 1 >= len(argv):
                raise CLIError(f"ERROR: No argument found for {tok}.")
            nxt = argv[i + 1]
            if spec.kind == "int":
                if not _good_int(nxt):
                    raise CLIError(f"ERROR: {nxt} is not a valid integer.")
                values[tok] = int(nxt)
            elif spec.kind == "double":
                if not _good_double(nxt):
                    # reference accepts scientific notation via atof? No:
                    # goodDouble rejects 'e'; match that strictness.
                    raise CLIError(f"ERROR: {nxt} is not a valid double.")
                values[tok] = float(nxt)
            elif spec.kind == "char":
                if len(nxt) != 1:
                    raise CLIError(f"ERROR: {nxt} is not a valid character.")
                values[tok] = nxt
            else:
                values[tok] = nxt
            i += 2
        else:  # list flags
            good = _good_int if spec.kind == "list-int" else _good_double
            conv = int if spec.kind == "list-int" else float
            items = []
            j = i + 1
            while j < len(argv):
                if good(argv[j]):
                    items.append(conv(argv[j]))
                    j += 1
                elif argv[j] not in specs:
                    raise CLIError(f"ERROR: {argv[j]} is not a valid "
                                   f"{'integer' if conv is int else 'double'}.")
                else:
                    break
            if not items:
                raise CLIError(f"ERROR: No arguments found for {tok}.")
            values[tok] = items
            i = j
    return ParsedArgs(values)


# ---------------------------------------------------------------------------
# Semantic validators (reference: src/garlic-cli.cpp:240-462).
# Each returns True on error after logging, like the reference check* family.
# ---------------------------------------------------------------------------

def check_cm(log, mapfile: str, cm: bool) -> bool:
    if cm and mapfile == DEFAULT_MAP:
        log.err("ERROR: Must provide mapfile if you wish to construct ROH in genetic map units.")
        return True
    return False


def check_nclust(log, nclust: int) -> bool:
    if nclust <= 0:
        log.err("ERROR: Must choose positive number for number of GMM clusters.")
        return True
    return False


def check_m(log, M: int) -> bool:
    if M <= 0:
        log.err("ERROR: M must be an integer > 0.")
        return True
    return False


def check_mu(log, mu: float) -> bool:
    if mu <= 0 or mu >= 1:
        log.err("ERROR: mu must be between 0 and 1.")
        return True
    return False


def check_build(log, build: str) -> bool:
    if build not in ("hg18", "hg19", "hg38", DEFAULT_BUILD):
        log.err("ERROR: Must choose hg18/hg19/hg38 for build version or provide a custom centromere file.")
        return True
    return False


def check_build_and_centromere_file(log, build: str, centromere_file: str) -> bool:
    if build == DEFAULT_BUILD and centromere_file == DEFAULT_CENTROMERE_FILE:
        log.err("ERROR: Must choose hg18/hg19/hg38 for build version or provide a custom centromere file.")
        return True
    return False


def check_multi_winsizes(log, multi: List[int]) -> tuple[bool, bool]:
    """Returns (error, winsize_explore)."""
    explore = False
    if multi[0] != DEFAULT_WINSIZE_MULTI:
        for w in multi:
            if w <= 0:
                log.err("ERROR: SNP window sizes must be > 1.")
                return True, False
        explore = True
    return False, explore


def check_auto_freq(log, freqfile: str, freq_only: bool) -> tuple[bool, bool]:
    """Returns (error, auto_freq)."""
    auto_freq = True
    if freqfile != DEFAULT_FREQ_FILE:
        auto_freq = False
        if freq_only:
            log.err("ERROR: Specifying both", ARG_FREQ_ONLY, nl=False)
            log.err(" and", ARG_FREQ_FILE, nl=False)
            log.err(" accomplishes nothing useful.")
            return True, auto_freq
    return False, auto_freq


def check_auto_winsize_step(log, step: int) -> bool:
    if step <= 0:
        log.err("ERROR: Step size for automatic window selection must be positive.")
        return True
    return False


def check_auto_cutoff(lod_cutoff: float) -> bool:
    """Returns auto_cutoff flag (no error path, src/garlic-cli.cpp:350-356)."""
    return lod_cutoff == DEFAULT_LOD_CUTOFF


def check_bound_sizes(log, bounds: List[float]) -> tuple[bool, bool]:
    """Returns (error, auto_bounds)."""
    if bounds[0] == DEFAULT_BOUND_SIZE and len(bounds) == 1:
        return False, True
    for i, b in enumerate(bounds):
        if b <= 0:
            log.err("ERROR: User provided size boundaries must be positive.")
            return True, False
        if i > 0 and b <= bounds[i - 1]:
            log.err("ERROR: User provided size boundaries must be in strictly increasing order.")
            return True, False
    return False, False


def check_required_files(log, tped: str, tfam: str) -> bool:
    if tped == DEFAULT_TPED or tfam == DEFAULT_TFAM:
        log.err("ERROR: Must provide both a tped and a tfam file.")
        return True
    return False


def check_map_file(log, mapfile: str, weighted: bool) -> bool:
    if mapfile == DEFAULT_MAP and weighted:
        log.err("ERROR: Weighted LOD score method requires a map file.")
        return True
    return False


def check_threads(log, n: int) -> bool:
    if n <= 0:
        log.err("ERROR: Number of threads must be > 0.")
        return True
    return False


def check_error(log, error: float, tglsfile: str) -> bool:
    if error <= 0 or error >= 1:
        if tglsfile == DEFAULT_TGLS:
            log.err("ERROR: Genotype error rate must be > 0 and < 1, or a TGLS file must be provided.")
            return True
    return False


def check_gl_type(log, gl_type: str, tglsfile: str) -> bool:
    if gl_type not in ("GQ", "GL", "PL") and tglsfile != DEFAULT_TGLS:
        log.err("ERROR: Must choose GQ/GL/PL for genotype likelihood format or provide a single error rate with --error.")
        return True
    return False


def check_winsize(log, winsize: int, explore: bool, auto: bool, weighted: bool) -> bool:
    if winsize <= 1 and not explore and not (auto and weighted):
        log.err("ERROR: SNP window size must be > 1. If using --auto-winsize, this is the starting value.")
        return True
    return False


def check_max_gap(log, max_gap: int) -> bool:
    if max_gap < 0:
        log.err("ERROR: Max gap must be > 0.")
        return True
    if max_gap < 1000:
        log.err("WARNING: max gap set very low:", max_gap)
    return False


def check_overlap_frac(log, frac: float) -> bool:
    if frac < 0 or frac > 1:
        log.err("ERROR: Overlap fraction must be >= 0 and <= 1.")
        return True
    return False
