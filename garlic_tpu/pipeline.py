"""End-to-end ROH-calling pipeline.

Sequences the four phases exactly as the reference driver does
(src/garlic-main.cpp:25-421): CLI -> load -> freq -> filter -> winsize ->
LOD/wLOD -> KDE cutoff -> assembly -> GMM size classes -> writers.  The .log
file content and ordering reproduce the reference byte-for-byte (it is a
declared comparison artifact).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import cli
from .centromeres import Centromere
from .cli import CLIError, ParsedArgs
from .core.types import Dataset, GarlicDataError
from .io import bed, filters, freqfile, genmap, kdefile, rawlod, tfam, tgls, tped
from .logger import RunLog
from .ops import assembly, convert, cutoff as cutoff_ops, density, device_win
from .ops import gmm, kde as kde_ops
from .ops import ld as ld_ops
from .ops import lod as lod_ops
from .ops import wiggle as wiggle_ops
from .ops import wlod as wlod_ops
from .version import OUTPUT_COMPAT_VERSION

AUTO_WINSIZE_THRESHOLD = 0.50


@dataclass
class PipelineState:
    log: RunLog
    args: ParsedArgs
    engine: str
    rng: np.random.Generator
    mesh: object = None  # jax.sharding.Mesh for the fast engine (--tpu-mesh)
    # (winsize, step, rows) -> exact f64 pooled Phase-II samples; set on
    # unweighted fast-engine runs so the KDE bandwidth/grid (and the .kde
    # x column, a compared artifact) are bit-identical to the oracle's
    # instead of derived from f32 device window scores.
    exact_sampler: object = None
    # io.poolcache.PoolCache: persists the exact Phase-II pool next to
    # the --tpu-panel-cache sidecar (content-keyed); warm runs skip the
    # sampler entirely.  None when uncacheable (no sidecar, multi-process,
    # unseeded --resample).
    pool_cache: object = None


def _resolve_mesh(spec: str, log):
    """Parse 'DPxSP' (or 'auto': factor all visible devices) and build the
    mesh (None for single-device)."""
    if spec in ("none", "", "1", "1x1"):
        return None
    from .parallel import factor_devices, make_mesh
    if spec == "auto":
        import jax
        n = len(jax.devices())
        if n <= 1:
            return None
        n_dp, n_sp = factor_devices(n)
    else:
        try:
            parts = spec.lower().replace(",", "x").split("x")
            n_dp = int(parts[0])
            n_sp = int(parts[1]) if len(parts) > 1 else 1
        except (ValueError, IndexError):
            raise CLIError(f"ERROR: bad {cli.ARG_MESH} spec '{spec}' "
                           "(expected DPxSP, e.g. 4x2, or auto)")
    try:
        return make_mesh(n_dp=n_dp, n_sp=n_sp)
    except ValueError as e:
        raise CLIError(f"ERROR: {e}")


def _resolve_engine(name: str) -> str:
    if name == "auto":
        # The device engine when a GPU is attached: the tie patrol makes
        # fast == exact BED by construction on every configuration, and
        # Phase II pools oracle-exact f64 samples on both engines — the
        # remaining fast-engine delta is the .kde y transform-precision
        # class, already far inside the oracle's own FIGTree
        # eps/randomness.  On a CPU-only host the native f64 exact path
        # is both the fidelity and the speed choice.
        from .runtime import accelerator
        return "fast" if accelerator() == "gpu" else "exact"
    if name not in ("exact", "fast"):
        raise CLIError(f"ERROR: unknown engine {name}")
    return name


def run_main(argv: List[str], prog: str = "garlic-tpu") -> int:
    """Entry point; returns the process exit status (matching the
    reference's return codes, including returning 0 on CLI parse failure,
    src/garlic-main.cpp:31-32)."""
    log = RunLog()
    try:
        args = cli.parse_command_line(argv)
    except CLIError as e:
        print(str(e), file=sys.stderr)
        return 0
    if args is None:  # --help
        return 0
    try:
        return _run(args, argv, prog, log)
    finally:
        log.close()


class _FreqWriter:
    """Background .freq.gz writer overlapping Phase I (the reference writes
    synchronously before Phase I, src/garlic-main.cpp:245-253; the writer
    only reads per-locus arrays, which filtering re-slices rather than
    mutates).  finish() is idempotent and runs on EVERY exit path (the
    wrapper's finally) so a write failure surfaces as a logged error and a
    nonzero exit instead of a raw traceback or a silently truncated file."""

    def __init__(self):
        self._thread = None
        self._exc = []

    def start(self, outfile: str, chroms, log, blob: str = None) -> None:
        import threading

        def _write():
            try:
                freqfile.write_freq(outfile + ".freq", chroms, log,
                                    blob=blob)
            except BaseException as e:  # surfaced at finish()
                self._exc.append(e)

        self._thread = threading.Thread(target=_write, daemon=False)
        self._thread.start()

    def finish(self):
        """Join and hand back the writer's exception (once), or None."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self._exc.pop() if self._exc else None


def _run(args: ParsedArgs, argv: List[str], prog: str, log: RunLog) -> int:
    fw = _FreqWriter()
    try:
        rc = _run_impl(args, argv, prog, log, fw)
    finally:
        werr = fw.finish()
    if werr is not None:
        log.err("ERROR: Failed writing allele frequency data:", str(werr))
        return 1 if rc == 0 else rc
    return rc


def _run_impl(args: ParsedArgs, argv: List[str], prog: str, log: RunLog,
              fw: _FreqWriter) -> int:
    outfile = args[cli.ARG_OUTFILE]
    # Multi-host: wire the jax.distributed runtime over DCN BEFORE any JAX
    # use when the GARLIC_TPU_COORD/NUM_PROCS env vars are set (every host
    # runs this same command; --tpu-mesh then spans all hosts' devices).
    # Secondary processes write to <out>.procN so co-located runs don't
    # race on the same artifact files.
    from .parallel.multihost import initialize_from_env
    _nproc, _pidx = initialize_from_env()
    if _pidx > 0:
        outfile = outfile + f".proc{_pidx}"
    log.init(outfile)
    log.log(" ".join([prog] + list(argv)))
    log.log("Output file basename:", outfile)

    argerr = False
    tpedfile = args[cli.ARG_TPED]
    tfamfile = args[cli.ARG_TFAM]
    tglsfile = args[cli.ARG_TGLS]
    argerr = argerr or cli.check_required_files(log, tpedfile, tfamfile)
    if argerr:
        return -1
    log.log("TPED file:", tpedfile)

    tped_missing = args[cli.ARG_TPED_MISSING]
    log.log("TPED missing data code:", tped_missing)
    log.log("TFAM file:", tfamfile)
    log.log("TGLS file:", tglsfile)

    gl_type = args[cli.ARG_GL_TYPE]
    argerr = argerr or cli.check_gl_type(log, gl_type, tglsfile)
    log.log("Genotype likelihood format:", gl_type)

    weighted = args[cli.ARG_WEIGHTED]
    mapfile = args[cli.ARG_MAP]
    cm = args[cli.ARG_CM]
    argerr = argerr or cli.check_cm(log, mapfile, cm)
    if argerr:
        return -1
    log.log("Measure ROH in genetic distance units:", cm)
    argerr = argerr or cli.check_map_file(log, mapfile, weighted or cm)
    log.log("Weighted LOD:", weighted)
    if weighted:
        log.log("Map file:", mapfile)

    build = args[cli.ARG_BUILD]
    argerr = argerr or cli.check_build(log, build)
    if argerr:
        return -1
    log.log("Genome build:", build)

    centromere_file = args[cli.ARG_CENTROMERE_FILE]
    argerr = argerr or cli.check_build_and_centromere_file(log, build, centromere_file)
    if argerr:
        return -1
    log.log("User defined centromere file:", centromere_file)

    nresample = args[cli.ARG_RESAMPLE]
    freqfile_arg = args[cli.ARG_FREQ_FILE]
    freq_only_flag = args[cli.ARG_FREQ_ONLY]
    err_flag, auto_freq = cli.check_auto_freq(log, freqfile_arg, freq_only_flag)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Calculate allele frequencies only:", freq_only_flag)
    log.log("Calculate allele frequencies from data:", auto_freq)
    if not auto_freq:
        log.log("Allele frequencies file:", freqfile_arg)
    else:
        if nresample <= 0:
            log.log("Allele frequencies resampled: FALSE")
        else:
            log.log("Allele frequencies resampled:", nresample)

    multi_winsizes = args[cli.ARG_WINSIZE_MULTI]
    err_flag, winsize_explore = cli.check_multi_winsizes(log, multi_winsizes)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Explore window sizes:", winsize_explore)
    if winsize_explore:
        log.logv("User defined window sizes:", multi_winsizes)

    auto_winsize = args[cli.ARG_AUTO_WINSIZE]
    log.log("Automatic window size:", auto_winsize)

    auto_winsize_step = args[cli.ARG_AUTO_WINSIZE_STEP]
    argerr = argerr or cli.check_auto_winsize_step(log, auto_winsize_step)
    if argerr:
        return -1
    log.log("Automatic window step size:", auto_winsize_step)

    winsize = args[cli.ARG_WINSIZE]
    argerr = argerr or cli.check_winsize(log, winsize, winsize_explore,
                                         auto_winsize, weighted)
    if argerr:
        return -1
    if not winsize_explore and not auto_winsize:
        log.log("User defined window size:", winsize)

    lod_cutoff = args[cli.ARG_LOD_CUTOFF]
    auto_cutoff = cli.check_auto_cutoff(lod_cutoff)
    log.log("Choose LOD score cutoff automatically:", auto_cutoff)
    if not auto_cutoff:
        log.log("User defined LOD score cutoff:", lod_cutoff)

    bound_sizes = list(args[cli.ARG_BOUND_SIZE])
    err_flag, auto_bounds = cli.check_bound_sizes(log, bound_sizes)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Choose ROH class thresholds automatically:", auto_bounds)
    if not auto_bounds:
        log.logv("User defined ROH class thresholds:", bound_sizes)

    num_threads = args[cli.ARG_THREADS]
    argerr = argerr or cli.check_threads(log, num_threads)
    log.log("Threads:", num_threads)
    from .native import set_native_threads
    set_native_threads(num_threads)  # caps OpenMP in the host kernels

    error = args[cli.ARG_ERROR]
    argerr = argerr or cli.check_error(log, error, tglsfile)
    if argerr:
        return -1
    log.log("Genotyping error:", error)

    max_gap = args[cli.ARG_MAX_GAP]
    argerr = argerr or cli.check_max_gap(log, max_gap)
    if argerr:
        return -1
    log.log("Max gap:", max_gap)

    overlap_frac = args[cli.ARG_OVERLAP_FRAC]
    argerr = argerr or cli.check_overlap_frac(log, overlap_frac)
    if argerr:
        return -1
    auto_overlap_frac = args[cli.ARG_AUTO_OVERLAP_FRAC]
    if auto_overlap_frac:
        log.log("Overlap fraction: automatic")
    elif overlap_frac != 0:
        log.log("Overlap fraction:", overlap_frac)
    else:
        log.log("Overlap fraction: 1/winsize")

    mu = args[cli.ARG_MU]
    argerr = argerr or cli.check_mu(log, mu)
    if argerr:
        return -1
    log.log("mu:", mu)

    M = args[cli.ARG_M]
    argerr = argerr or cli.check_m(log, M)
    if argerr:
        return -1
    log.log("M:", M)

    nclust = args[cli.ARG_NCLUST]
    argerr = argerr or cli.check_nclust(log, nclust)
    if argerr:
        return -1
    log.log("# GMM clusters:", nclust)

    kde_subsample = args[cli.ARG_KDE_SUBSAMPLE]
    if kde_subsample <= 0:
        log.log("# of rand individuals for KDE: ALL")
    else:
        log.log("# of rand individuals for KDE:", kde_subsample)

    ld_subsample = args[cli.ARG_LD_SUBSAMPLE]
    if ld_subsample <= 0:
        log.log("# of rand individuals for LD: ALL")
    else:
        log.log("# of rand individuals for LD:", ld_subsample)

    raw_lod = args[cli.ARG_RAW_LOD]
    log.log("Output raw LOD scores:", raw_lod)

    phased = args[cli.ARG_PHASED]
    log.log("Use r2 for weighting phased data:", phased)

    thin = not args[cli.ARG_KDE_THINNING]
    log.log("Use thinning for KDE estimation:", thin)

    seed = args[cli.ARG_SEED]
    eff_seed = None if seed < 0 else seed
    if eff_seed is None and _nproc > 1:
        # Derive the run seed on process 0 and broadcast it: every
        # cooperating process must draw the SAME --kde-subsample /
        # --ld-subsample indices and --resample binomials, or the psum'd
        # sharded stages would silently mix different subsets
        # (SURVEY.md:105; the reference's time(NULL) seeding is preserved
        # in spirit — still time-derived, just cluster-consistent).
        import jax
        from jax.experimental import multihost_utils
        # int32 range: without x64 the broadcast truncates int64 lanes,
        # and a wrapped-negative seed crashes default_rng (flaked ~50%)
        local = np.zeros(1, dtype=np.int32)
        if jax.process_index() == 0:
            local[0] = np.random.default_rng().integers(0, 2 ** 31 - 1)
        eff_seed = int(multihost_utils.broadcast_one_to_all(local)[0]) \
            & 0x7FFFFFFF
    rng = np.random.default_rng(eff_seed)
    engine = _resolve_engine(args[cli.ARG_ENGINE])
    if engine == "fast":
        from .runtime import enable_compile_cache
        enable_compile_cache()
    from .runtime import PhaseProfiler
    prof = PhaseProfiler(args[cli.ARG_PROFILE])

    if freq_only_flag:
        tped.freq_only(tpedfile, outfile, nresample, tped_missing, log, rng)
        return 0

    # Resolve the device mesh BEFORE loading: per-host sharded input needs
    # the dp extent to compute this host's genotype column range.
    try:
        mesh = _resolve_mesh(args[cli.ARG_MESH], log) \
            if engine == "fast" else None
    except CLIError as e:
        log.err(str(e))
        return -1

    # Per-host column-range loading (multi-process runs): each process
    # parses/holds only its own dp-row block of individuals — host RAM
    # and upload bytes scale 1/num_hosts — and the global allele freqs
    # come from the production count psum (allele_freq_counts_sharded).
    # Engaged on row-aligned unweighted runs; exploration modes that
    # subset individuals host-side keep the replicated full parse.
    # Round 5 extends per-host input to weighted runs (phased included —
    # the native range parser emits first-copy bits for its column
    # slice): the LD band's pair counts psum over the distributed rows,
    # the exact band for the tie patrol / Phase-II sampler reassembles
    # from psum'd integer count planes, and hom freqs psum like allele
    # freqs.
    # (cm composes too: the scaffold filter and the genetic-map
    # interpolation are per-locus and the loader holds positions/gpos in
    # full; the weighted explore mode keeps full-panel Phase I per
    # candidate and subsets at the sampler, like the plain searches.)
    col_range = None
    if _nproc > 1 and engine == "fast" and mesh is not None:
        from .parallel.multihost import dp_layout_aligned
        # missing-file guard: peek_nind would raise a raw FileNotFoundError
        # here, before load_tped's clean logged-ERROR path (ADVICE r4);
        # fall through and let load_tped report it
        if dp_layout_aligned(mesh) and os.path.exists(tpedfile):
            from .parallel.mesh import AXIS_DP
            nind_file = tped.peek_nind(tpedfile)
            n_dp = mesh.shape[AXIS_DP]
            I2 = -(-max(nind_file, 1) // n_dp) * n_dp
            per = I2 // _nproc
            # per >= nind would hand process 0 the FULL panel (the parser
            # then demotes it to single-process semantics while later
            # ranks keep sharded state — asymmetric collectives hang);
            # such tiny panels gain nothing from sharding anyway
            if nind_file > 0 and per < nind_file:
                c0 = min(_pidx * per, nind_file)
                col_range = (c0, min(c0 + per, nind_file))
                print(f"[garlic-tpu] sharded input: process {_pidx} "
                      f"holds individuals [{col_range[0]}, {col_range[1]}) "
                      f"of {nind_file}", file=sys.stderr)

    # ---------------- Datafile reading ----------------
    centro = Centromere(build, centromere_file, cli.DEFAULT_CENTROMERE_FILE, log)
    use_gl = False
    try:
        ds, num_loci = tped.load_tped(
            tpedfile, tped_missing, nresample, phased, auto_freq, log, rng,
            panel_cache=args[cli.ARG_PANEL_CACHE],
            # fast engine ships 2-bit codes to the device: the parser can
            # emit them directly, skipping the int8 transpose entirely
            packed_geno=(engine == "fast" and not phased),
            col_range=col_range)
        if col_range is not None and auto_freq:
            # Production freq collective: psum the per-host partial count
            # planes into the global freq (bit-identical to the
            # reference's nalleles/total — integer counts, one division).
            # Warm panel-cache loads already carry the stored global
            # freq.  The path choice must be CLUSTER-WIDE: on multi-host
            # disks one host can hit its sidecar (global freq, no count
            # planes) while another cold-parses (count planes) — gating
            # each host on its local state would leave them in different
            # collectives and hang.  Tiny flag allgather first; mixed
            # states take the lowest cached rank's global planes.
            import jax
            from jax.experimental import multihost_utils
            from .parallel.engine import allele_freq_counts_sharded
            have_counts = all(c.freq_num is not None for c in ds.chroms)
            if _nproc > 1:
                flags = np.asarray(multihost_utils.process_allgather(
                    np.array([[1 if have_counts else 0]], dtype=np.int32),
                    tiled=True))[:, 0]
            else:
                flags = np.array([1 if have_counts else 0])
            if flags.all():
                for c in ds.chroms:
                    c.freq = allele_freq_counts_sharded(c.freq_num,
                                                        c.freq_den, mesh)
                    c.freq_num = c.freq_den = None
            else:
                src = int(np.flatnonzero(flags == 0)[0])
                for c in ds.chroms:
                    plane = (np.zeros(c.nloci, dtype=np.float64)
                             if have_counts
                             else np.asarray(c.freq, dtype=np.float64))
                    with jax.enable_x64(True):
                        allp = np.asarray(multihost_utils.process_allgather(
                            plane[None], tiled=True))
                    c.freq = allp[src]
                    c.freq_num = c.freq_den = None
            if nresample > 0:
                for c in ds.chroms:
                    # deferred from load_tped: resample the GLOBAL freq
                    # with the cluster-consistent rng
                    # (src/garlic-data.cpp:142-148)
                    counts = rng.binomial(nresample,
                                          np.clip(c.freq, 0.0, 1.0))
                    c.freq = counts.astype(np.float64) / float(nresample)
        if os.environ.get("GT_FREQ_DEBUG"):
            import hashlib
            for c in ds.chroms:
                fh = hashlib.blake2b(np.ascontiguousarray(
                    np.asarray(c.freq, dtype=np.float64)).tobytes(),
                    digest_size=8).hexdigest()
                print(f"[gt_freq] {c.chrom} {fh}", file=sys.stderr)
        if os.environ.get("GT_LOAD_STATS"):
            # test/benchmark hook: per-process loaded genotype bytes + peak
            # RSS so far (stderr only; never in .log)
            import resource
            tot = rows = 0
            for c in ds.chroms:
                rows = max(rows, c.nind)
                for a in (c._geno, c._geno2b, c.first_copy):
                    if a is not None:
                        tot += a.nbytes
            print(f"[garlic-tpu] load-stats: rows={rows} geno_bytes={tot} "
                  f"maxrss_kb={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}",
                  file=sys.stderr)
        log.log("Total loci:", num_loci)
        ds.ind_ids, ds.pop = tfam.read_tfam(tfamfile, log)
        num_ind = ds.nind
        log.log("Population:", ds.pop)
        log.log("Total diploid individuals:", num_ind)
        for c in ds.chroms:
            if c.nind_global != num_ind:
                log.err("ERROR: TPED and TFAM disagree on individual count.")
                return 1

        if tglsfile != cli.DEFAULT_TGLS:
            tgls.read_tgls(tglsfile, ds.chroms, num_ind, gl_type, log,
                           panel_cache=bool(args[cli.ARG_PANEL_CACHE]),
                           col_range=col_range)
            use_gl = True

        scaffolds = None
        if weighted or cm:
            scaffolds = genmap.load_map_scaffold(mapfile, centro, log)
            if len(scaffolds) != len(ds.chroms):
                log.err("ERROR: Scaffold genetic map does not have the same "
                        "number of chromosomes as data.")
                return -1
    except (GarlicDataError, FileNotFoundError):
        # expected load failure: ERROR text already in .error (the
        # reference's catch(...) { return 1; }, src/garlic-main.cpp:210-242)
        return 1
    except Exception as e:
        log.err("ERROR: Internal failure while loading data:", repr(e))
        return 1
    prof.mark("load", num_loci * ds.nind, "genotypes")

    # ---------------- Allele frequencies ----------------
    if auto_freq:
        # computed-from-data, non-resampled freqs are a pure function of
        # the panel-cache sidecar: cache the finished gz blob next to it
        blob = (ds.panel_cache_file + ".freq.gz"
                if ds.panel_cache_file is not None and nresample == 0
                else None)
        fw.start(outfile, list(ds.chroms), log, blob=blob)
    else:
        print(f"Loading user provided allele frequencies from {freqfile_arg}")
        try:
            freqfile.read_freq(freqfile_arg, ds.chroms, log)
        except (GarlicDataError, FileNotFoundError):
            return -1
        except Exception as e:
            log.err("ERROR: Internal failure while reading allele "
                    "frequencies:", repr(e))
            return -1

    prof.mark("freq", num_loci, "loci")

    # ---------------- Filtering ----------------
    if weighted or cm:
        ds.chroms, new_loci = filters.filter_monomorphic_and_oob(ds.chroms, scaffolds)
        log.log("Monomorphic or out of bounds loci filtered:", num_loci - new_loci)
        num_interp = 0
        for c, s in zip(ds.chroms, scaffolds):
            c.gpos, n = genmap.interpolate_genetic_map(c.positions, s)
            num_interp += n
        log.log("Number of genetic map locations interpolated:", num_interp)
    else:
        ds.chroms, new_loci = filters.filter_monomorphic(ds.chroms)
        log.log("Monomorphic loci filtered:", num_loci - new_loci)

    log.log("Total loci used for analysis:", new_loci)
    num_loci = new_loci
    prof.mark("filter", num_loci, "loci")

    variant_density = -1.0
    if (auto_winsize and weighted) or auto_overlap_frac:
        variant_density = density.calc_density(num_loci, ds.chroms, centro)

    st = PipelineState(log=log, args=args, engine=engine, rng=rng, mesh=mesh)
    if engine == "fast" and not weighted:
        # Phase II reads oracle-exact f64 rolling window samples (the
        # device f32 scores would shift the nrd0 bandwidth and with it
        # every .kde x value); assembly keeps the device matrices +
        # tie patrol.  Weighted runs get the equivalent sampler below,
        # once the --ld-subsample indices are drawn (Phase I).
        # Multi-process: replicated-input runs compute the identical pool
        # on every host; per-host column-range runs pool their own rows
        # and allgather per chromosome in rank order, which IS the global
        # row order (rank r holds rows [r*per, (r+1)*per)).  The flag is
        # derived from col_range (set identically on every process BEFORE
        # the parse), never from per-process chromosome state — every
        # rank must take the same collective path.
        if col_range is not None:
            st.exact_sampler = \
                lambda wq, step, rows: _exact_thinned_samples_sharded(
                    ds.chroms, centro, wq, error, max_gap, use_gl, step,
                    rows)
        else:
            st.exact_sampler = lambda wq, step, rows: _exact_thinned_samples(
                ds.chroms, centro, wq, error, max_gap, use_gl, step, rows)
        if _nproc == 1 and ds.panel_cache_file is not None \
                and nresample == 0:
            # pool cache (--tpu-panel-cache sidecar): warm auto-cutoff
            # runs replay the grid scalars / mmap the pool instead of
            # re-running the exact sampler (1.4-5 s at the 1000x1M
            # scale).  Content-keyed on the FILTERED panel digests —
            # never engaged multi-process (a per-host hit/miss split
            # would desync the sharded sampler's collectives) or under
            # --resample (unseeded freqs never re-key).
            from .io.poolcache import PoolCache, pool_key
            st.pool_cache = PoolCache(
                ds.panel_cache_file,
                lambda wq, stp: pool_key(ds.chroms, wq, stp, error,
                                         max_gap, use_gl, centro))

    # ---------------- Winsize resolution ----------------
    kde_result = None
    if winsize_explore and auto_winsize and not weighted:
        kde_result, winsize = _select_winsize_from_list(
            st, ds, centro, multi_winsizes, error, use_gl, max_gap,
            kde_subsample, outfile, thin)
        if kde_result is None:
            return 1
    elif winsize_explore:
        _explore_winsizes(st, ds, centro, multi_winsizes, error, use_gl,
                          max_gap, kde_subsample, outfile, weighted, M, mu,
                          phased, thin, ld_subsample)
        return 0
    elif auto_winsize:
        if not weighted:
            try:
                kde_result, winsize = _select_winsize(
                    st, ds, centro, winsize, auto_winsize_step, error, use_gl,
                    max_gap, kde_subsample, outfile, thin)
            except GarlicDataError:
                return 1
            except Exception as e:
                log.err("ERROR: Internal failure during window size "
                        "selection:", repr(e))
                return 1
            if kde_result is None:
                return 1
        else:
            winsize = density.select_winsize_weighted(variant_density)
        log.log("Selected window size:", winsize)

    print(f"Window size: {winsize}")

    if auto_overlap_frac:
        overlap_frac = density.select_overlap_frac(variant_density, winsize)
        log.log("Selected overlap fraction:", overlap_frac)

    # ---------------- Phase I ----------------
    wpair_cache = {}
    if weighted:
        print("Calculating LD matrix.", file=sys.stderr)
        sub_idx = _ld_subsample_idx(ds.nind, ld_subsample, rng)
        if engine == "fast":
            # Weighted Phase II now has the same exactness guarantee as
            # plain runs: oracle-exact f64 thinned wLOD samples (the
            # .kde x column / bandwidth / grid are byte-identical to the
            # oracle's); the pair band memoizes into wpair_cache, which
            # the weighted tie patrol shares.  The reference's Phase II
            # is the same computeKDE for weighted runs
            # (src/garlic-main.cpp:374-378, src/garlic-kde.cpp:14-140).
            # Per-host column-range loads pool owned rows against the
            # psum'd global pair band and allgather in rank order.
            if col_range is not None:
                st.exact_sampler = \
                    lambda wq, step, rows: _exact_thinned_wsamples_sharded(
                        ds.chroms, centro, wq, error, max_gap, use_gl,
                        step, rows, mu, M, phased, sub_idx, wpair_cache)
            else:
                st.exact_sampler = \
                    lambda wq, step, rows: _exact_thinned_wsamples(
                        ds.chroms, centro, wq, error, max_gap, use_gl,
                        step, rows, mu, M, phased, sub_idx, wpair_cache)
            if _nproc == 1 and ds.panel_cache_file is not None \
                    and nresample == 0:
                from .io.poolcache import PoolCache, pool_key
                st.pool_cache = PoolCache(
                    ds.panel_cache_file,
                    lambda wq, stp: pool_key(
                        ds.chroms, wq, stp, error, max_gap, use_gl,
                        centro, weighted=True, mu=mu, M=M, phased=phased,
                        sub_idx=sub_idx))
        win_by_chr = []
        from .core.pbar import Bar
        print(f"Calculating LOD scores with winsize {winsize}.", file=sys.stderr)
        for c in ds.chroms:
            print(f"{c.chrom}    ", file=sys.stderr, end="")
            bar = Bar(total=c.nind)
            if st.engine == "fast" and st.mesh is not None:
                # SPMD weighted path: psum'd pair counts for the LD band
                # + halo'd weighted window scan over the mesh
                from .parallel.engine import (ld_band_sharded,
                                              wlod_windows_sharded)
                ldm = ld_band_sharded(c, winsize, phased, sub_idx, st.mesh)
                win_by_chr.append(wlod_windows_sharded(
                    c, centro, ldm, winsize, error, max_gap, use_gl, mu, M,
                    st.mesh))
                bar.advance(c.nind)
            elif st.engine == "fast":
                from .ops import device_wlod
                win_by_chr.append(device_wlod.weighted_windows_device(
                    c, centro, winsize, error, max_gap, use_gl, mu, M,
                    phased, sub_idx))
                bar.advance(c.nind)
            else:
                ldm = ld_ops.calc_ld(c, winsize, phased, sub_idx,
                                     engine=st.engine)
                win_by_chr.append(wlod_ops.wlod_windows(
                    c, centro, ldm, winsize, error, max_gap, use_gl, mu, M,
                    bar=bar))
            bar.finalize()
    else:
        win_by_chr = _calc_lod_windows(st, ds, centro, winsize, error,
                                       max_gap, use_gl)
    # The freq writer keeps running through Phase II/III (it only reads
    # per-locus arrays no later phase mutates); _run's finally joins it and
    # reports failure with exit 1, so deferring the join just overlaps the
    # gzip+format work with assembly instead of blocking here.
    prof.mark("phase1-lod",
              sum(max(c.nloci - winsize + 1, 0) for c in ds.chroms)
              * ds.nind, "windows")

    if raw_lod:
        try:
            rawlod.write_win_data(win_by_chr,
                                  [c.chrom for c in ds.chroms], ds.pop, outfile)
        except Exception as e:
            log.err("ERROR: Failed to write raw LOD windows:", repr(e))
            return -1

    # ---------------- Phase II: cutoff ----------------
    if auto_cutoff:
        if kde_result is None:
            lod_cutoff = _select_lod_cutoff(
                st, win_by_chr, ds, kde_subsample,
                kdefile.make_kde_filename(outfile, winsize),
                winsize if thin else 1, winsize)
        else:
            lod_cutoff = _cutoff_from_kde(st, kde_result, winsize)
        log.log("Selected LOD score cutoff:", lod_cutoff)
    else:
        print(f"User defined LOD score cutoff: {lod_cutoff}")
    prof.mark("phase2-cutoff")

    # ---------------- Phase III: assembly ----------------
    print("Assembling ROH windows")
    # Tie patrol (every fast-engine configuration): rows holding a window
    # inside the f32 error band around the cutoff get their coverage
    # recomputed with the exact f64 engine, making the fast BED identical
    # to the oracle's by construction.  Multi-process runs verify too:
    # with replicated input every host re-derives every suspect
    # identically; with per-host column-range input each host verifies
    # the rows it owns and the results merge with a rank-ordered
    # allgather (suspect sets are tiny).
    tie_delta, exact_cover, exact_window = 0.0, None, None
    # cluster-consistent by construction: col_range is computed from the
    # mesh/args identically on every process before the parse
    sharded_rows = col_range is not None
    if st.engine == "fast" and not weighted:
        tie_delta = _tie_band(ds.chroms, winsize, error, use_gl)

        def _cover_local(ci, rows):
            from .ops.assembly import (coverage_counts_batch,
                                       overlap_threshold)
            thr = overlap_threshold(overlap_frac, winsize)
            rows = np.asarray(rows, dtype=np.int64)
            out = []
            # row blocks bound the [k, L] f64/int64 temporaries: fresh
            # multi-GB allocations page-fault for seconds under this VM
            for s in range(0, rows.size, 64):
                sub = _subset_chrom_rows(ds.chroms[ci],
                                         rows[s:s + 64])
                w = lod_ops.calc_lod_windows(sub, centro, winsize, error,
                                             max_gap, use_gl,
                                             engine="exact")
                out.append(coverage_counts_batch(w >= lod_cutoff,
                                                 winsize) >= thr)
            return np.concatenate(out, axis=0) if out else \
                np.zeros((0, ds.chroms[ci].nloci), dtype=bool)

        def _window_local(ci, rows, wins, sides):
            return _exact_window_flips(
                ds.chroms[ci], rows, wins, sides, winsize, error,
                use_gl, lod_cutoff)

        if sharded_rows:
            exact_cover, exact_window = _owned_row_patrol(
                ds, _cover_local, _window_local)
        else:
            exact_cover, exact_window = _cover_local, _window_local
    elif st.engine == "fast" and weighted:
        # weighted: 1/LD can amplify terms arbitrarily, so the band scale
        # rides each DeviceWin as a device scalar (max finite |term| —
        # the single-device kernel and the sharded mesh kernel both ship
        # one) and tie_delta here is only the 256*eps*W FACTOR (same
        # calibrated margin class as _tie_band; the reference's wLOD
        # windows are fresh sums, so the per-window f64 verification is
        # its exact value).  Replicated multi-process runs verify locally
        # and identically everywhere; per-host column-range runs (round
        # 5) verify owned rows against the exact band assembled from the
        # psum'd global pair counts and merge via _owned_row_patrol.
        tie_delta = 256.0 * 2.0 ** -23 * winsize
        _wband_cache = {}

        def _wband(ci):
            if ci not in _wband_cache:
                # assemble the exact band from the pair band the Phase-II
                # sampler may already have memoized (identical values:
                # calc_ld(engine="exact") == assemble_ld_exact(pair_ld))
                P = (_wpair_band_sharded(ds.chroms, ci, winsize, phased,
                                         sub_idx, wpair_cache)
                     if sharded_rows else
                     _wpair_band(ds.chroms, ci, winsize, phased, sub_idx,
                                 wpair_cache))
                _wband_cache[ci] = ld_ops.assemble_ld_exact(P, winsize)
            return _wband_cache[ci]

        def _wcover_local(ci, rows):
            from .ops.assembly import (coverage_counts_batch,
                                       overlap_threshold)
            band = _wband(ci)  # collective on sharded runs: always first
            thr = overlap_threshold(overlap_frac, winsize)
            rows = np.asarray(rows, dtype=np.int64)
            out = []
            for s in range(0, rows.size, 64):  # bound [k, L] temporaries
                sub = _subset_chrom_rows(ds.chroms[ci],
                                         rows[s:s + 64])
                w = wlod_ops.wlod_windows(sub, centro, band,
                                          winsize, error, max_gap, use_gl,
                                          mu, M)
                out.append(coverage_counts_batch(w >= lod_cutoff,
                                                 winsize) >= thr)
            return np.concatenate(out, axis=0) if out else \
                np.zeros((0, ds.chroms[ci].nloci), dtype=bool)

        def _wwindow_local(ci, rows, wins, sides):
            P = (_wpair_band_sharded(ds.chroms, ci, winsize, phased,
                                     sub_idx, wpair_cache)
                 if sharded_rows else wpair_cache.get((ci, winsize)))
            return _exact_wlod_window_flips(
                ds.chroms[ci], rows, wins, sides, winsize, error, use_gl,
                mu, M, phased, sub_idx, lod_cutoff, P=P)

        if sharded_rows:
            exact_cover, exact_window = _owned_row_patrol(
                ds, _wcover_local, _wwindow_local)
        else:
            exact_cover, exact_window = _wcover_local, _wwindow_local

    roh_by_ind, lengths = assembly.assemble_roh(
        win_by_chr, ds.chroms, ds.ind_ids, centro, lod_cutoff, winsize,
        max_gap, overlap_frac, cm, tie_delta=tie_delta,
        exact_cover=exact_cover, exact_window=exact_window)
    prof.mark("phase3-assembly", float(lengths.size), "ROH")

    # ---------------- Phase IV: size classes ----------------
    if auto_bounds:
        print(f"Fitting {nclust}-component GMM for size classification")
        try:
            bound_sizes, _ = gmm.select_size_classes(
                lengths, nclust, log, mesh=st.mesh,
                device=(st.engine == "fast"))
        except Exception as e:
            # The reference aborts inside GSL here (collapsed component /
            # root bracket failure); we fail cleanly instead.
            log.err("ERROR: GMM size classification failed:", str(e))
            log.err("\tToo few ROH calls or degenerate length distribution; "
                    "size boundaries can be supplied with --size-bounds.")
            return 1
        log.logv("Selected ROH size boundaries = (", bound_sizes, nl=False)
        log.log(" )")
    else:
        log.logv("User provided ROH size boundaries = (", bound_sizes, nl=False)
        log.log(" )")

    prof.mark("phase4-gmm")
    print("Writing ROH tracts.")
    bed.write_roh(bed.make_roh_filename(outfile), roh_by_ind,
                  [c.chrom for c in ds.chroms], bound_sizes, ds.pop,
                  OUTPUT_COMPAT_VERSION, cm, log)
    prof.mark("write-bed")
    prof.report()
    print("Finished.")
    return 0


# ---------------------------------------------------------------------------
# Helpers mirroring garlic-roh.cpp drivers
# ---------------------------------------------------------------------------

def _calc_lod_windows(st: PipelineState, ds: Dataset, centro, winsize: int,
                      error: float, max_gap: int, use_gl: bool,
                      ind_idx: Optional[np.ndarray] = None):
    """calcLODWindows (src/garlic-roh.cpp:279-309)."""
    from .core.pbar import Bar
    print(f"Calculating LOD scores with winsize {winsize}.", file=sys.stderr)
    # HBM budget: when every chromosome's window matrix cannot stay
    # device-resident at once (22-chrom WGS panels), hand back
    # rematerializable thunks — consumers extract thinned samples /
    # coverage bits per chromosome and recompute instead of holding
    # (SURVEY.md hard part e).
    streaming = False
    if st.engine == "fast":
        from .runtime import hbm_budget
        # half the usable budget: the resident window matrices must
        # coexist with the coverage program's own [I, L]-sized
        # temporaries, the genotype cache, and XLA scratch, so a window
        # set near the full budget runs out of memory during assembly.
        # With a mesh the matrices shard over every device, so the gate
        # is the AGGREGATE budget (per-device x device count) and
        # streaming composes with the mesh: the LazyWin thunk
        # rematerializes the SHARDED DeviceWin.
        ndev = 1 if st.mesh is None else int(st.mesh.devices.size)
        budget = 0.5 * hbm_budget() * ndev
        est = sum(4.0 * c.nind_global * max(c.nloci - winsize + 1, 1)
                  for c in ds.chroms)
        streaming = est > budget
        if streaming:
            print(f"[garlic-tpu] window matrices ~{est / 1e9:.1f} GB exceed "
                  f"the {'mesh aggregate ' if ndev > 1 else ''}HBM budget; "
                  "streaming per chromosome", file=sys.stderr)
    out = []
    for c in ds.chroms:
        print(f"{c.chrom}    ", file=sys.stderr, end="")
        # reference quirk: the unweighted bar's total is NLOCI but it
        # advances once per INDIVIDUAL (src/garlic-roh.cpp:40,48), so it
        # displays " 0%" during compute and "100%" at finalize
        bar = Bar(total=c.nloci)
        cc = c
        if ind_idx is not None:
            cc = _subset_chrom(c, ind_idx)
        if st.engine == "fast" and st.mesh is not None:
            # SPMD over the ("dp", "sp") mesh: individuals data-parallel,
            # loci sequence-parallel with a ppermute halo; TGLS per-genotype
            # errors shard exactly like the genotypes
            from .parallel.engine import lod_windows_sharded
            if streaming:
                out.append(device_win.LazyWin(
                    (lambda cc=cc: lod_windows_sharded(
                        cc, centro, winsize, error, max_gap, st.mesh,
                        use_gl=use_gl)),
                    nind=cc.nind_global, nloci=cc.nloci))
            else:
                out.append(lod_windows_sharded(cc, centro, winsize, error,
                                               max_gap, st.mesh,
                                               use_gl=use_gl))
            bar.advance(cc.nind)
        elif st.engine == "fast" and streaming:
            out.append(device_win.LazyWin(
                (lambda cc=cc: device_win.lod_windows_device(
                    cc, centro, winsize, error, max_gap, use_gl)),
                nind=cc.nind, nloci=cc.nloci))
            bar.advance(cc.nind)
        elif st.engine == "fast":
            # device-resident: no [I, L] matrix crosses the host link
            out.append(device_win.lod_windows_device(
                cc, centro, winsize, error, max_gap, use_gl))
            bar.advance(cc.nind)
        else:
            out.append(lod_ops.calc_lod_windows(
                cc, centro, winsize, error, max_gap, use_gl,
                engine=st.engine, bar=bar))
        bar.finalize()
    return out


def _tie_band(chroms, winsize: int, error: float, use_gl: bool) -> float:
    """Suspect half-width for the fast engine's tie patrol: a bound on
    |win_f32 - win_f64| for one window sum.

    Calibrated on the device (chip_smoke.py's tie-band phase measures
    max |win_f32 - win_f64| / (eps32 * W * tmax) for W = 60/120/300 and
    TGLS, and fails above 64, a quarter of this band; tmax = the largest
    |per-locus LOD term|).

    tmax comes from corner evaluation (O(L) min/max instead of a full
    f64 table build): every term is monotone in p ((1-e)/(1-p) + e and
    its mirror) and the heterozygote term is exactly log10(e), so the
    extremes sit at (min/max freq) x (min/max error); the plain path is
    the e = error degenerate case of the same formulas."""
    eps = 2.0 ** -23
    tmax = 1.0
    for c in chroms:
        tmax = max(tmax, _corner_tmax(c, error, use_gl))
    return 256.0 * eps * winsize * tmax


_corner_tmax_cache = {}


def _corner_tmax(c, error: float, use_gl: bool) -> float:
    """max |per-locus LOD term| bound for one chromosome by corner
    evaluation (see _tie_band: terms are monotone in p, extremes at
    (min/max freq) x (min/max error)).  Memoized per freq array (the
    patrol evaluates it once in _tie_band and again per chromosome's
    window verification; the [L] min/max scans cost ~10 ms each at WGS
    scale)."""
    key = (id(c.freq), float(error), bool(use_gl))
    hit = _corner_tmax_cache.get(key)
    if hit is not None and hit[0] is c.freq:
        return hit[1]
    tmax = _corner_tmax_compute(c, error, use_gl)
    if len(_corner_tmax_cache) >= 8:
        _corner_tmax_cache.pop(next(iter(_corner_tmax_cache)))
    _corner_tmax_cache[key] = (c.freq, tmax)
    return tmax


def _corner_tmax_compute(c, error: float, use_gl: bool) -> float:
    tmax = 1.0
    f = np.asarray(c.freq, dtype=np.float64)
    live = (f > 0) & (f < 1)
    if not live.any():
        return tmax
    if not use_gl:
        es = (float(error),)
    elif c.gl_codes is not None:
        es = (float(np.min(c.gl_lut)), float(np.max(c.gl_lut)))
    else:
        es = (float(np.min(c.gl)), float(np.max(c.gl)))
    for p in (float(f[live].min()), float(f[live].max())):
        for e in es:
            for v in ((1.0 - e) / (1.0 - p) + e, e,
                      (1.0 - e) / p + e):
                tmax = max(tmax, abs(float(np.log10(v))))
    return tmax


def _geno_cols_slice(c, w: int, W: int) -> np.ndarray:
    """int8 genotype codes [I, W] for loci [w, w+W) — decoded from the
    2-bit form when the chromosome is packed-only."""
    if not c.geno_is_packed_only:
        return np.asarray(c.genotypes[:, w:w + W])
    b = c.geno2b[:, w // 4:-(-(w + W) // 4)]
    codes = np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(b.shape[0], -1)
    g = codes[:, w % 4:w % 4 + W]
    return np.where(g == 3, -9, g).astype(np.int8)


def _wlod_score_slice(c, i: int, w: int, W: int, error, use_gl: bool,
                      mu: float, M: int) -> np.ndarray:
    """f64 weighted per-locus scores for individual i, loci [w, w+W) —
    exactly wlod_scores' values/order ((lod * nomut) * norec,
    src/garlic-roh.cpp:249) without materializing the [I, L] matrix."""
    from .ops.lod import lod_terms
    g = _geno_row_slice(c, i, w, W)
    if use_gl and c.gl_codes is not None:
        e = c.gl_lut[c.gl_codes[i, w:w + W]][None, :]
    elif use_gl:
        e = np.asarray(c.gl[i, w:w + W], dtype=np.float64)[None, :]
    else:
        e = error
    base = lod_terms(g[None, :], c.freq[w:w + W], e)[0]
    pos = c.positions.astype(np.float64)
    gpos = c.gpos.astype(np.float64)
    dpos = np.empty(W)
    dg = np.empty(W)
    dpos[0] = pos[w] if w == 0 else pos[w] - pos[w - 1]
    dg[0] = gpos[w] if w == 0 else gpos[w] - gpos[w - 1]
    dpos[1:] = pos[w + 1:w + W] - pos[w:w + W - 1]
    dg[1:] = gpos[w + 1:w + W] - gpos[w:w + W - 1]
    nomut = np.exp(-2.0 * M * mu * dpos)
    norec = np.exp(-2.0 * M * 1.0 * dg)
    return (base * nomut) * norec


def _exact_wlod_window_flips(c, rows, wins, sides, winsize: int, error,
                             use_gl: bool, mu: float, M: int, phased: bool,
                             sub_idx, cutoff: float,
                             P: np.ndarray = None) -> np.ndarray:
    """Weighted tie-patrol verification: per suspect (row, window), does
    the f64 decision flip versus the device's f32 one?

    The reference's wLOD has NO rolling update — every window is a fresh
    left-to-right sum (src/garlic-roh.cpp:259-272) — so this f64
    recomputation is the oracle's exact value, not an approximation: the
    window's LD row comes from the locus slice [w, w+W) alone (the band
    entries only involve in-window pairs) through the same pair formulas
    and per-entry summation order as ops/ld.py's exact engine.

    P: optional full pair band (the sampler/patrol memo, or the psum'd
    GLOBAL band on per-host column-range runs — REQUIRED there, since
    local rows alone cannot reproduce full-panel pair counts); band rows
    then assemble from it with the identical k-loop order."""
    from .ops import ld as ld_ops
    flips = np.empty(len(rows), dtype=bool)
    band_rows = {}
    for k in range(len(rows)):
        i, w = int(rows[k]), int(wins[k])
        if w not in band_rows:
            if P is not None:
                band_rows[w] = ld_ops.assemble_ld_exact_rows(
                    P, winsize, np.array([w]))[0]
            else:
                gsl = _geno_cols_slice(c, w, winsize)
                if phased:
                    P2 = ld_ops.pair_ld_r2(gsl,
                                           c.first_copy[:, w:w + winsize],
                                           c.freq[w:w + winsize], winsize,
                                           sub_idx)
                else:
                    hf = ld_ops.geno_hom_freq(gsl)
                    P2 = ld_ops.pair_ld_hr2(gsl, hf, winsize, sub_idx)
                band_rows[w] = ld_ops.assemble_ld_exact(P2, winsize)[0]
        score = _wlod_score_slice(c, i, w, winsize, error, use_gl, mu, M)
        with np.errstate(divide="ignore", invalid="ignore"):
            # a zero band entry divides to inf exactly as the reference's
            # score/LD does; non-finite sums escalate below
            terms = score * (1.0 / band_rows[w])
            s = float(np.cumsum(terms)[-1])  # the reference's i-loop order
        if not np.isfinite(s):
            flips[k] = True  # inf/nan band: escalate to the exact row
            continue
        flips[k] = (s >= cutoff) != bool(sides[k])
    return flips


def _geno_row_slice(c, i: int, w: int, W: int) -> np.ndarray:
    """int8 genotype codes [W] for individual i, loci [w, w+W) — decoded
    from the 2-bit form when the chromosome is packed-only, so the tie
    patrol never materializes the full int8 matrix."""
    if not c.geno_is_packed_only:
        return np.asarray(c.genotypes[i, w:w + W])
    b = c.geno2b[i, w // 4:-(-(w + W) // 4)]
    codes = np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(-1)
    g = codes[w % 4:w % 4 + W]
    return np.where(g == 3, -9, g).astype(np.int8)


def _exact_window_flips(c, rows, wins, sides, winsize: int, error: float,
                        use_gl: bool, cutoff: float) -> np.ndarray:
    """Per suspect (row, window): does the f64 'window >= cutoff'
    decision FLIP versus the device's f32 one (`sides`)?  The tie
    patrol's cheap verification stage — ~winsize-term fresh f64 sums,
    microseconds per window.

    The oracle accumulates most windows by the ROLLING subtract/add
    recurrence, whose value can differ from a fresh left-to-right sum by
    up to ~n_updates rounding errors; a suspect whose fresh sum lands
    within the drift bound of the cutoff is conservatively reported as
    flipped, which routes its row to the full exact rolling
    recomputation (exact_cover).  The bound scales with the rolling
    update count (<= nwin; 2 f64 ops each, intermediates <= (W+1)*tmax)
    instead of a fixed 1e-9, which a 1M-window chromosome's worst-case
    drift (~1e-8) could exceed (round-3 advisor)."""
    from .ops.lod import lod_terms
    nwin = max(c.positions.shape[0] - winsize + 1, 1)
    tmax = _corner_tmax(c, error, use_gl)
    esc = max(1e-9, 4.0 * nwin * 2.0 ** -52 * (winsize + 1) * tmax)
    rows = np.asarray(rows, dtype=np.int64)
    wins = np.asarray(wins, dtype=np.int64)
    W = winsize
    # one batched gather for ALL suspects: a pinned cutoff near a dense
    # window-value region can flag thousands, and a per-suspect Python
    # loop costs ~50 us each (~200 ms at the 1000x1M scale, measured).
    # The arithmetic is IDENTICAL to the per-suspect version: per-row
    # cumsum == the sequential left-to-right f64 sum.
    gv = _geno_windows_batch(c, rows, wins, W)
    cols = wins[:, None] + np.arange(W)
    if use_gl and c.gl_codes is not None:
        e = c.gl_lut[c.gl_codes[rows[:, None], cols]]
    elif use_gl:
        e = np.asarray(c.gl, dtype=np.float64)[rows[:, None], cols]
    else:
        e = error
    fv = c.freq[cols]
    # lod_terms broadcasts elementwise: [k, W] genotypes against each
    # suspect's own [k, W] freq window, the reference's exact per-element
    # operation order
    terms = lod_terms(gv, fv, e)
    s = np.cumsum(terms, axis=1, dtype=np.float64)[:, -1]
    unsure = np.abs(s - cutoff) < esc
    return unsure | ((s >= cutoff) != np.asarray(sides).astype(bool))


def _geno_windows_batch(c, rows: np.ndarray, wins: np.ndarray,
                        W: int) -> np.ndarray:
    """int8 genotype codes [k, W] for suspect (row, window-start) pairs —
    decoded straight from the 2-bit packed bytes when the chromosome is
    packed-only (gathers only the ~W/4 bytes each suspect needs; the
    int8 matrix never exists)."""
    if not c.geno_is_packed_only:
        cols = wins[:, None] + np.arange(W)
        return np.asarray(c.genotypes)[rows[:, None], cols]
    if c._geno2b is None and c.geno2b_parent is not None:
        # compaction still deferred: decode per-element from the
        # UNFILTERED parent payload via the kept-column index map —
        # [k, W] byte gathers instead of firing the whole-matrix
        # compaction thunk (~20 ms/chromosome on warm WGS runs)
        pb, idx = c.geno2b_parent
        pidx = idx[wins[:, None] + np.arange(W)]       # parent columns
        byts = pb[rows[:, None], pidx >> 2]
        g = (byts >> ((pidx & 3) * 2)) & 3
        return np.where(g == 3, -9, g).astype(np.int8)
    rb = c.geno2b.shape[1]
    nbytes = W // 4 + 2  # covers any w%4 alignment
    bidx = np.minimum(wins[:, None] // 4 + np.arange(nbytes), rb - 1)
    byts = c.geno2b[rows[:, None], bidx]                   # [k, nbytes]
    k = rows.shape[0]
    codes = np.stack([(byts >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(k, 4 * nbytes)
    cols = (wins % 4)[:, None] + np.arange(W)
    g = np.take_along_axis(codes, cols, axis=1)
    return np.where(g == 3, -9, g).astype(np.int8)


def _owned_row_patrol(ds: Dataset, cover_local, window_local):
    """Tie-patrol wrappers for per-host column-range input: suspect rows
    index the GLOBAL individual axis but each host only holds
    [row0, row0 + nind); every host f64-verifies the rows it owns and the
    per-row results merge with a rank-ordered allgather-OR (suspect sets
    are tiny — bytes, not matrices).  The merged result is identical on
    every process, so each one applies the same repairs to its gathered
    coverage."""
    from jax.experimental import multihost_utils

    def _merge(arr):
        allp = np.asarray(multihost_utils.process_allgather(
            arr[None].astype(np.uint8), tiled=True))
        return allp.any(axis=0)

    def exact_cover(ci, rows):
        # Gather only each host's OWNED rows, bit-packed: a full [k, L]
        # bool allgather would ship p*k*L bytes (multi-GB when a bitmap
        # fallback routes thousands of flagged rows here); owned slices
        # ship p*max_owned*L/8 — ~8p x less on balanced suspect sets.
        c = ds.chroms[ci]
        r0, nown = c.row0, c.nind
        L = c.nloci
        rb = (L + 7) // 8
        rows = np.asarray(rows, dtype=np.int64)
        owned = (rows >= r0) & (rows < r0 + nown)
        kown = int(owned.sum())
        # ALWAYS invoke, even with zero owned rows: sharded weighted
        # implementations open collectives (the psum'd pair band) that
        # every rank must join — the suspect set is cluster-consistent,
        # the ownership split is not
        cov = cover_local(ci, rows[owned] - r0)
        cov_own = np.zeros((kown, rb), dtype=np.uint8)
        if kown:
            cov_own = np.packbits(cov, axis=1, bitorder="little")
        n = np.array([[kown]], dtype=np.int32)
        ns = np.asarray(multihost_utils.process_allgather(
            n, tiled=True))[:, 0]
        kmax = max(int(ns.max()), 1)
        pad = np.zeros((1, kmax, rb), dtype=np.uint8)
        pad[0, :kown] = cov_own
        allp = np.asarray(multihost_utils.process_allgather(pad,
                                                            tiled=True))
        om = np.asarray(multihost_utils.process_allgather(
            owned[None].astype(np.uint8), tiled=True)).astype(bool)
        out_p = np.zeros((rows.size, rb), dtype=np.uint8)
        for r in range(allp.shape[0]):
            idx = np.flatnonzero(om[r])
            out_p[idx] = allp[r, :idx.size]
        return np.unpackbits(out_p, axis=1,
                             bitorder="little")[:, :L].astype(bool)

    def exact_window(ci, rows, wins, sides):
        c = ds.chroms[ci]
        r0, nown = c.row0, c.nind
        rows = np.asarray(rows, dtype=np.int64)
        owned = (rows >= r0) & (rows < r0 + nown)
        flips = np.zeros(rows.size, dtype=bool)
        # always invoke (see exact_cover): collectives inside must run
        # on every rank even when this one owns no suspect rows
        flips[owned] = window_local(
            ci, rows[owned] - r0, np.asarray(wins)[owned],
            np.asarray(sides)[owned])
        return _merge(flips)

    return exact_cover, exact_window


def _subset_chrom_rows(c, idx):
    """_subset_chrom for a FEW rows without firing the whole-matrix
    packed-column compaction (tie-patrol exact repair: 2-3 flip rows at
    the 1000x1M scale paid the ~50 ms deferred [I, L/4] compaction just
    to read them): decode the selected rows from the UNFILTERED parent
    payload and column-gather the kept loci."""
    from .core.types import ChromData
    if not (c.geno_is_packed_only and c._geno2b is None
            and c.geno2b_parent is not None):
        return _subset_chrom(c, idx)
    pb, kidx = c.geno2b_parent
    rows_b = np.asarray(pb[np.asarray(idx, dtype=np.int64)])
    k = rows_b.shape[0]
    codes = np.stack([(rows_b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(k, -1)
    g = codes[:, kidx]
    g = np.where(g == 3, -9, g).astype(np.int8)
    return ChromData(chrom=c.chrom, positions=c.positions, gpos=c.gpos,
                     locus_names=c.locus_names, alleles=c.alleles,
                     genotypes=g, freq=c.freq,
                     first_copy=None if c.first_copy is None
                     else c.first_copy[idx],
                     gl=None if c._gl is None else c._gl[idx],
                     gl_codes=None if c.gl_codes is None
                     else c.gl_codes[idx],
                     gl_lut=c.gl_lut)


def _subset_chrom(c, idx):
    from .core.types import ChromData
    packed = c.geno_is_packed_only
    return ChromData(chrom=c.chrom, positions=c.positions, gpos=c.gpos,
                     locus_names=c.locus_names, alleles=c.alleles,
                     genotypes=None if packed else c.genotypes[idx],
                     freq=c.freq,
                     first_copy=None if c.first_copy is None else c.first_copy[idx],
                     gl=None if c._gl is None else c._gl[idx],
                     gl_codes=None if c.gl_codes is None else c.gl_codes[idx],
                     gl_lut=c.gl_lut,
                     geno2b=c.geno2b[idx] if packed else None)


def _ld_subsample_idx(nind: int, ld_subsample: int,
                      rng: np.random.Generator) -> Optional[np.ndarray]:
    if ld_subsample >= nind or ld_subsample <= 0:
        return None
    return np.sort(rng.choice(nind, size=ld_subsample, replace=False))


def _exact_thinned_samples(chroms, centro, winsize: int, error: float,
                           max_gap: int, use_gl: bool, step: int,
                           rows) -> np.ndarray:
    """Oracle-exact pooled Phase-II samples: per chromosome, the f64
    ROLLING window sequence (the thinned values depend on the full
    rolling history, src/garlic-roh.cpp:76-103) for the requested rows,
    thinned by `step` and MISSING-filtered exactly like
    convertWinData2DoubleData (src/garlic-data.cpp:2026-2150).  Row
    chunks bound the [k, L] f64 temporaries (fresh multi-GB allocations
    page-fault for seconds under this VM)."""
    from .core.types import MISSING
    parts = []
    thin_native = None
    if not use_gl:
        from .native import lod_windows_exact_thin_native
        thin_native = lod_windows_exact_thin_native
    for c in chroms:
        r = np.arange(c.nind) if rows is None \
            else np.asarray(rows, dtype=np.int64)
        table = miss8 = None
        if thin_native is not None:
            # thinned rolling kernel: identical recurrence, but the full
            # [64, L] f64 window matrix per chunk never exists — at the
            # 1000x1M scale the thin-after-compute route spent ~10 s in
            # 512 MB allocations + discarded writes (measured)
            from .ops.lod import window_missing_mask
            table = lod_ops.lod_table(c.freq, error)
            nwin = max(c.nloci - winsize + 1, 0)
            miss8 = np.zeros(max(nwin, 1), dtype=np.uint8)
            if nwin > 0:
                miss8[:] = window_missing_mask(
                    c.positions, winsize, max_gap, centro.start(c.chrom),
                    centro.end(c.chrom)).astype(np.uint8)
        for s in range(0, r.size, 64):
            sub = _subset_chrom(c, r[s:s + 64])
            w = None
            if thin_native is not None:
                w = thin_native(sub.genotypes, table, miss8, winsize, step)
            if w is None:
                wf = lod_ops.calc_lod_windows(sub, centro, winsize, error,
                                              max_gap, use_gl,
                                              engine="exact")
                w = wf[:, ::step]
            flat = w.reshape(-1)
            m = (flat != MISSING) & ~np.isnan(flat)
            parts.append(flat[m])
    return np.concatenate(parts) if parts else np.zeros(0)


def _wpair_band(chroms, ci: int, winsize: int, phased: bool, sub_idx,
                cache: dict) -> np.ndarray:
    """Exact pairwise LD band P for one chromosome, memoized per
    (chromosome, winsize) — shared between the weighted exact Phase-II
    sampler and the weighted tie patrol so the O(L*W*I_sub) pair counting
    runs at most once per run."""
    key = (ci, winsize)
    P = cache.get(key)
    if P is None:
        P = ld_ops.pair_ld(chroms[ci], winsize, phased, sub_idx)
        cache[key] = P
    return P


def _wpair_band_sharded(chroms, ci: int, winsize: int, phased: bool,
                        sub_idx, cache: dict) -> np.ndarray:
    """GLOBAL exact pairwise LD band on per-host column-range input:
    per-host integer joint-count planes over owned rows (the global
    --ld-subsample reduces to owned-row intersection, matching the LD
    engine's masking) psum across the cluster, then the exact division
    sequence (pair_ld_*_from_counts) — bit-identical to the full-panel
    pair band.  COLLECTIVE: every rank must call this for the same
    (chromosome, winsize) sequence.  Memoized like _wpair_band."""
    key = (ci, winsize)
    P = cache.get(key)
    if P is not None:
        return P
    import jax
    from jax.experimental import multihost_utils
    c = chroms[ci]
    rows = None
    if sub_idx is not None:
        rr = np.asarray(sub_idx, dtype=np.int64)
        rows = rr[(rr >= c.row0) & (rr < c.row0 + c.nind)] - c.row0
    g = c.genotypes if rows is None else c.genotypes[rows]
    if phased:
        fcl = c.first_copy if rows is None else c.first_copy[rows]
        n1, n2 = ld_ops.pair_counts_r2(g, fcl, winsize)
    else:
        n1, n2 = ld_ops.pair_counts_hr2(g, winsize)
    # marginal hom freqs over ALL individuals (never subsampled,
    # src/garlic-data.cpp:648)
    hom, tot = ld_ops.geno_hom_counts(c.genotypes)
    flat = np.concatenate([n1.reshape(-1), n2.reshape(-1), hom, tot])
    # x64 REQUIRED: allgather silently downcasts int64 without it
    with jax.enable_x64(True):
        planes = np.asarray(multihost_utils.process_allgather(
            flat[None], tiled=True))
    tot_planes = planes.sum(axis=0)
    sz = n1.size
    n1g = tot_planes[:sz].reshape(n1.shape)
    n2g = tot_planes[sz:2 * sz].reshape(n1.shape)
    if phased:
        P = ld_ops.pair_ld_r2_from_counts(n1g, n2g, c.freq, winsize)
    else:
        HA = ld_ops.geno_hom_freq_from_counts(
            tot_planes[2 * sz:2 * sz + hom.size],
            tot_planes[2 * sz + hom.size:])
        P = ld_ops.pair_ld_hr2_from_counts(n1g, n2g, HA, winsize)
    cache[key] = P
    return P


def _exact_thinned_wsamples_sharded(chroms, centro, winsize: int, error,
                                    max_gap: int, use_gl: bool, step: int,
                                    rows, mu: float, M: int, phased: bool,
                                    sub_idx, pair_cache: dict) -> np.ndarray:
    """_exact_thinned_wsamples on per-host column-range input: the exact
    band assembles identically on every host from the psum'd global pair
    counts; each host pools its owned rows' f64 thinned wLOD windows and
    the per-chromosome pools concatenate in rank order (rank r holds
    global rows [r*per, (r+1)*per), so rank order IS the reference's
    pooling order)."""
    import jax
    from jax.experimental import multihost_utils

    from .core.types import MISSING
    from .ops.lod import window_missing_mask
    out = []
    for ci, c in enumerate(chroms):
        L = c.nloci
        nwin = L - winsize + 1
        r0, nown = c.row0, c.nind
        if rows is None:
            local_rows = np.arange(nown, dtype=np.int64)
        else:
            rr = np.asarray(rows, dtype=np.int64)
            local_rows = rr[(rr >= r0) & (rr < r0 + nown)] - r0
        part = np.zeros(0, dtype=np.float64)
        if nwin > 0:
            # collective — unconditional on every rank (local_rows may
            # be empty here while another rank owns samples)
            P = _wpair_band_sharded(chroms, ci, winsize, phased, sub_idx,
                                    pair_cache)
            ws = np.arange(0, nwin, step)
            missing = window_missing_mask(
                c.positions, winsize, max_gap, centro.start(c.chrom),
                centro.end(c.chrom))[ws]
            inv = 1.0 / ld_ops.assemble_ld_exact_rows(P, winsize, ws)
            parts = []
            for s in range(0, local_rows.size, 64):
                sub = _subset_chrom(c, local_rows[s:s + 64])
                score = wlod_ops.wlod_scores(sub, error, use_gl, mu, M)
                acc = np.zeros((score.shape[0], ws.size), dtype=np.float64)
                for j in range(winsize):
                    acc = acc + score[:, ws + j] * inv[:, j][None, :]
                w = np.where(missing[None, :], float(MISSING), acc)
                flat = w.reshape(-1)
                m2 = (flat != MISSING) & ~np.isnan(flat)
                parts.append(flat[m2])
            if parts:
                part = np.concatenate(parts)
        # rank-padded allgather (see _exact_thinned_samples_sharded)
        with jax.enable_x64(True):
            n = np.array([part.shape[0]], dtype=np.int64)
            ns = np.asarray(multihost_utils.process_allgather(
                n[None], tiled=True))[:, 0]
            cap = int(ns.max())
            if cap == 0:
                continue
            pad = np.zeros(cap, dtype=np.float64)
            pad[:part.shape[0]] = part
            allp = np.asarray(multihost_utils.process_allgather(
                pad[None], tiled=True))
        for r in range(allp.shape[0]):
            out.append(allp[r, :int(ns[r])])
    return np.concatenate(out) if out else np.zeros(0)


def _exact_thinned_wsamples(chroms, centro, winsize: int, error,
                            max_gap: int, use_gl: bool, step: int, rows,
                            mu: float, M: int, phased: bool, sub_idx,
                            pair_cache: dict) -> np.ndarray:
    """Oracle-exact pooled Phase-II samples for WEIGHTED runs: the f64
    wLOD window values at the thinned positions, in the reference's
    pooling order (chrom-major, row-major; convertWinData2DoubleData,
    src/garlic-data.cpp:2026-2150).

    The reference's wLOD has NO rolling recurrence — every window is a
    fresh left-to-right sum over score[i] / LD[l][i-l]
    (src/garlic-roh.cpp:259-272) — so only the thinned window positions
    need evaluating: the exact LD band rows are assembled per-position
    from the memoized pair band (assemble_ld_exact_rows — the reference's
    per-entry k-loop order), and each window sums in wlod_windows' exact
    j-loop order.  The full [I, L] f64 window matrix (and the O(L*W^2)
    full band assembly) never materialize; cost is
    O(L*W*I_sub + (L/step)*W^2 + rows*(L/step)*W)."""
    from .core.types import MISSING
    from .ops.lod import window_missing_mask
    parts = []
    for ci, c in enumerate(chroms):
        L = c.nloci
        nwin = L - winsize + 1
        r = np.arange(c.nind) if rows is None \
            else np.asarray(rows, dtype=np.int64)
        if nwin <= 0 or r.size == 0:
            continue
        P = _wpair_band(chroms, ci, winsize, phased, sub_idx, pair_cache)
        ws = np.arange(0, nwin, step)
        missing = window_missing_mask(
            c.positions, winsize, max_gap, centro.start(c.chrom),
            centro.end(c.chrom))[ws]
        band = ld_ops.assemble_ld_exact_rows(P, winsize, ws)
        inv = 1.0 / band                                     # [nw, W]
        for s in range(0, r.size, 64):  # bound [k, L] temporaries
            sub = _subset_chrom(c, r[s:s + 64])
            score = wlod_ops.wlod_scores(sub, error, use_gl, mu, M)
            acc = np.zeros((score.shape[0], ws.size), dtype=np.float64)
            for j in range(winsize):
                # reference i-loop order (src/garlic-roh.cpp:259-272):
                # score[i] * (1.0 / LD[l][i-l]), exactly wlod_windows
                acc = acc + score[:, ws + j] * inv[:, j][None, :]
            w = np.where(missing[None, :], float(MISSING), acc)
            flat = w.reshape(-1)
            m2 = (flat != MISSING) & ~np.isnan(flat)
            parts.append(flat[m2])
    return np.concatenate(parts) if parts else np.zeros(0)


def _exact_thinned_samples_sharded(chroms, centro, winsize: int,
                                   error: float, max_gap: int, use_gl: bool,
                                   step: int, rows) -> np.ndarray:
    """_exact_thinned_samples for per-host column-range input: each host
    pools the exact f64 thinned samples of the rows it owns, then the
    per-chromosome pools concatenate across ranks — rank r holds global
    rows [r*per, (r+1)*per), so rank-order concatenation reproduces the
    reference's exact chrom-major/row-major pooling order (and with it
    the GSL bandwidth recurrence inputs, byte-for-byte).  Sample pools
    are variable-length per rank (MISSING filtering, tail rows), so the
    gather pads to the allgathered max and re-slices."""
    import jax
    from jax.experimental import multihost_utils
    out = []
    for c in chroms:
        r0, nown = c.row0, c.nind
        if rows is None:
            local_rows = None  # all locally-held rows, in order
        else:
            rr = np.asarray(rows, dtype=np.int64)
            local_rows = rr[(rr >= r0) & (rr < r0 + nown)] - r0
        part = _exact_thinned_samples([c], centro, winsize, error,
                                      max_gap, use_gl, step, local_rows)
        # x64 REQUIRED: without it process_allgather silently downcasts
        # the f64 samples to f32 (and int64 counts to int32), shifting
        # nrd0/the .kde grid in the 7th digit (measured)
        with jax.enable_x64(True):
            n = np.array([part.shape[0]], dtype=np.int64)
            ns = np.asarray(multihost_utils.process_allgather(
                n[None], tiled=True))[:, 0]
            cap = int(ns.max())
            if cap == 0:
                continue
            pad = np.zeros(cap, dtype=np.float64)
            pad[:part.shape[0]] = part
            allp = np.asarray(multihost_utils.process_allgather(
                pad[None], tiled=True))
        assert allp.dtype == np.float64
        for r in range(allp.shape[0]):
            out.append(allp[r, :int(ns[r])])
    return np.concatenate(out) if out else np.zeros(0)


def _compute_kde_for(st: PipelineState, win_by_chr, step: int, ind_idx,
                     log, exact=None):
    """Phase-II dispatch: device-resident KDE when the fast engine holds
    the window matrices on device (sample pooling + bandwidth + transform
    in one jit, ~8 KB over the link), host/mesh path otherwise.

    exact=(winsize, rows): on runs with an exact_sampler (unweighted fast
    engine), pool oracle-exact f64 samples on the host instead of reading
    the f32 device matrices — bandwidth, grid, and the .kde x column then
    match the oracle bit-for-bit; only the O(N x 512) transform stays on
    device."""
    if exact is not None and st.exact_sampler is not None:
        wq, rows = exact
        hybrid_ok = st.engine == "fast" and st.mesh is None
        grid = samples = None
        ent = (st.pool_cache.lookup(wq, step)
               if rows is None and st.pool_cache is not None else None)
        if ent is not None:
            # warm pool-cache hit: grid scalars replay bit-exactly from
            # the sidecar; the pool itself only loads (mmap, original
            # pooling order) if a non-hybrid path needs the transform
            grid = ent.grid()
            if hybrid_ok and ent.n >= 2_000_000:
                kr = kde_ops.compute_kde_hybrid(None, win_by_chr, step,
                                                ind_idx=ind_idx, log=log,
                                                grid=grid)
                if kr is not None:
                    return kr
            samples = ent.load()
        else:
            samples = st.exact_sampler(wq, step, rows)
            if rows is None and st.pool_cache is not None:
                # persists in the background; returns the grid scalars
                # (this run needs the nrd0/sort anyway — computed once)
                grid = st.pool_cache.store(wq, step, samples)
        if hybrid_ok and samples.size >= 2_000_000:
            # WGS-scale pools: reuse the device-resident thinned windows
            # for the transform's y instead of uploading the exact
            # samples; keep the exact host samples for bandwidth/grid
            # (compute_kde_hybrid)
            # NOTE: subset by _compute_kde_for's ind_idx (the selector in
            # the windows' OWN row space) — `rows` indexes the full panel
            # and the winsize-search paths pass windows already subset
            kr = kde_ops.compute_kde_hybrid(samples, win_by_chr, step,
                                            ind_idx=ind_idx, log=log,
                                            grid=grid)
            if kr is not None:
                return kr
        return kde_ops.compute_kde(samples, log,
                                   device=(st.engine == "fast"),
                                   mesh=st.mesh, grid=grid)
    if st.engine == "fast" and st.mesh is None:
        kr = kde_ops.compute_kde_wins(win_by_chr, step, ind_idx=ind_idx,
                                      log=log)
        if kr is not None:
            return kr
    samples = convert.win_to_samples(win_by_chr, step, ind_idx=ind_idx)
    return kde_ops.compute_kde(samples, log, device=(st.engine == "fast"),
                               mesh=st.mesh)


def _select_lod_cutoff(st: PipelineState, win_by_chr, ds: Dataset,
                       kde_subsample: int, kdeoutfile: str, step: int,
                       wsize: int) -> float:
    """selectLODCutoff (src/garlic-roh.cpp:667-697): thin/subsample, KDE,
    write, min-between-modes.  Failures return -1 and the pipeline continues,
    exactly like the reference."""
    log = st.log
    idx = None
    if kde_subsample > 0:
        idx = convert.choose_subsample(ds.nind, kde_subsample, st.rng)
        log.logn("Individuals used for KDE: ")
        for i in idx:
            log.logn(ds.ind_ids[i])
            log.logn(" ")
        log.logn("\n")
    print("Estimating distribution of raw LOD score windows:", file=sys.stderr)
    kr = _compute_kde_for(st, win_by_chr, step, idx, log,
                          exact=(wsize, idx))
    try:
        kdefile.write_kde(kr, kdeoutfile, log)
    except Exception:
        return -1.0
    try:
        c = cutoff_ops.get_min_btw_modes(kr.x, kr.y, wsize)
    except Exception:
        log.err("ERROR: Failed to find the minimum between modes in the LOD score density.")
        log.err("\tResults from density estimation have been written to file for inspection.")
        log.err("\tA cutoff can be manually specified on the command line with",
                cli.ARG_LOD_CUTOFF)
        return -1.0
    _report_cutoff_rivals(kr, wsize, c)
    return c


def _report_cutoff_rivals(kr, wsize: int, cutoff: float) -> None:
    """stderr-only note when the auto-KDE cutoff has FIGTree-error-scale
    rivals: the reference's Phase II is randomized run-to-run (time-seeded
    FIGTree clustering — see ops.cutoff.cutoff_tie_probe), so on such
    densities the oracle itself selects different cutoffs on different
    runs.  Never written to .log (a compared artifact)."""
    try:
        alts = cutoff_ops.cutoff_tie_probe(kr.x, kr.y, wsize)
    except Exception:
        return
    if alts:
        # cap at the 3 rivals nearest the selection: wide low-density
        # valleys can flag dozens of grid points (every one inside the
        # FIGTree error bound), and a 17-value list is noise no user can
        # act on — the count carries the instability scale
        near = sorted(alts, key=lambda a: abs(a - cutoff))[:3]
        more = len(alts) - len(near)
        tail = " (+%d more)" % more if more > 0 else ""
        print("[garlic-tpu] note: auto-KDE cutoff %g has %d FIGTree-"
              "error-scale rival(s), nearest %s%s; the reference's "
              "randomized Phase II (time-seeded FIGTree) may pick any "
              "reachable rival on a given run"
              % (cutoff, len(alts), ", ".join("%g" % a for a in near),
                 tail), file=sys.stderr)


def _cutoff_from_kde(st: PipelineState, kde_result, wsize: int) -> float:
    """selectLODCutoff(KDEResult*) (src/garlic-roh.cpp:652-664)."""
    try:
        c = cutoff_ops.get_min_btw_modes(kde_result.x, kde_result.y, wsize)
        _report_cutoff_rivals(kde_result, wsize, c)
        return c
    except Exception:
        st.log.err("ERROR: Failed to find the minimum between modes in the LOD score density.")
        st.log.err("\tResults from density estimation have been written to file for inspection.")
        st.log.err("\tA cutoff can be manually specified on the command line with",
                   cli.ARG_LOD_CUTOFF)
        return -1.0


def _subset_for_kde(st: PipelineState, ds: Dataset, kde_subsample: int):
    """subsetData (src/garlic-data.cpp:2171-2244) + its log line."""
    idx = convert.choose_subsample(ds.nind, kde_subsample, st.rng)
    st.log.loga("Individuals used for KDE:", [ds.ind_ids[i] for i in idx])
    return idx


def _sharded_rows_mode(ds: Dataset) -> bool:
    """True on per-host column-range loads: winsize-search Phase I then
    keeps the FULL (distributed) panel and the KDE row subset applies
    downstream — global indices can't subset a local row block, and the
    device search windows are cheap at full width (the reference's
    subsetData existed to bound single-core CPU cost,
    src/garlic-data.cpp:2171)."""
    return bool(ds.chroms) and ds.chroms[0].nind_total is not None


def _select_winsize(st: PipelineState, ds: Dataset, centro, winsize: int,
                    step: int, error: float, use_gl: bool, max_gap: int,
                    kde_subsample: int, outfile: str, thin: bool):
    """selectWinsize (src/garlic-roh.cpp:766-850): grow winsize by step until
    the wiggle metric <= 0.5."""
    log = st.log
    ind_idx = _subset_for_kde(st, ds, kde_subsample) if kde_subsample > 0 else None
    sharded = _sharded_rows_mode(ds)
    log.log("Searching for acceptable window size, smoothness threshold:",
            AUTO_WINSIZE_THRESHOLD)
    log.log("winsize\tsmoothness")
    wq = winsize
    while True:
        win_by_chr = _calc_lod_windows(st, ds, centro, wq, error, max_gap,
                                       use_gl,
                                       ind_idx=None if sharded else ind_idx)
        kr = _compute_kde_for(st, win_by_chr, wq if thin else 1,
                              ind_idx if sharded else None, log,
                              exact=(wq, ind_idx))
        mse = wiggle_ops.calculate_wiggle(kr)
        log.log("", wq, nl=False)
        log.log("\t", mse)
        if mse <= AUTO_WINSIZE_THRESHOLD:
            selected = kr.clone()
            kdefile.write_kde(selected, kdefile.make_kde_filename(outfile, wq), log)
            return selected, wq
        wq += step


def _select_winsize_from_list(st: PipelineState, ds: Dataset, centro,
                              multi: List[int], error: float, use_gl: bool,
                              max_gap: int, kde_subsample: int, outfile: str,
                              thin: bool):
    """selectWinsizeFromList (src/garlic-roh.cpp:852-933)."""
    log = st.log
    ind_idx = _subset_for_kde(st, ds, kde_subsample) if kde_subsample > 0 else None
    sharded = _sharded_rows_mode(ds)
    log.log("Searching for acceptable window size, smoothness threshold:",
            AUTO_WINSIZE_THRESHOLD)
    log.log("winsize\tsmoothness")
    for i, wq in enumerate(multi):
        win_by_chr = _calc_lod_windows(st, ds, centro, wq, error, max_gap,
                                       use_gl,
                                       ind_idx=None if sharded else ind_idx)
        kr = _compute_kde_for(st, win_by_chr, wq if thin else 1,
                              ind_idx if sharded else None, log,
                              exact=(wq, ind_idx))
        mse = wiggle_ops.calculate_wiggle(kr)
        log.log("", wq, nl=False)
        log.log("\t", mse)
        if mse <= AUTO_WINSIZE_THRESHOLD or i == len(multi) - 1:
            selected = kr.clone()
            kdefile.write_kde(selected, kdefile.make_kde_filename(outfile, wq), log)
            return selected, wq
    return None, 0


def _explore_winsizes(st: PipelineState, ds: Dataset, centro,
                      multi: List[int], error: float, use_gl: bool,
                      max_gap: int, kde_subsample: int, outfile: str,
                      weighted: bool, M: int, mu: float, phased: bool,
                      thin: bool, ld_subsample: int):
    """exploreWinsizes (src/garlic-roh.cpp:699-763): dump a KDE per candidate
    winsize and exit."""
    log = st.log
    ind_idx = _subset_for_kde(st, ds, kde_subsample) if kde_subsample > 0 else None
    sharded = _sharded_rows_mode(ds)
    for wq in multi:
        if weighted:
            sub_idx = _ld_subsample_idx(ds.nind, ld_subsample, st.rng)
            if st.engine == "fast":
                # same exactness guarantee as the main weighted path:
                # the dumped .kde x columns are byte-identical to the
                # oracle's (fresh sampler per candidate — sub_idx is
                # redrawn for each winsize, matching the reference's
                # per-candidate calcLDData, src/garlic-roh.cpp:699-763)
                if sharded:
                    st.exact_sampler = (
                        lambda w2, step, rows, _si=sub_idx:
                        _exact_thinned_wsamples_sharded(
                            ds.chroms, centro, w2, error, max_gap,
                            use_gl, step, rows, mu, M, phased, _si, {}))
                else:
                    st.exact_sampler = (
                        lambda w2, step, rows, _si=sub_idx:
                        _exact_thinned_wsamples(
                            ds.chroms, centro, w2, error, max_gap, use_gl,
                            step, rows, mu, M, phased, _si, {}))
            win_by_chr = []
            print(f"Calculating LOD scores with winsize {wq}.", file=sys.stderr)
            for c in ds.chroms:
                print(f"{c.chrom}    ", file=sys.stderr, end="")
                # sharded loads keep the full (distributed) panel — the
                # KDE subset applies downstream via global indices
                cc = _subset_chrom(c, ind_idx) \
                    if ind_idx is not None and not sharded else c
                if st.engine == "fast" and st.mesh is not None:
                    from .parallel.engine import (ld_band_sharded,
                                                  wlod_windows_sharded)
                    ldm = ld_band_sharded(c, wq, phased, sub_idx, st.mesh)
                    win_by_chr.append(wlod_windows_sharded(
                        cc, centro, ldm, wq, error, max_gap, use_gl, mu, M,
                        st.mesh))
                elif st.engine == "fast":
                    from .ops import device_wlod
                    if cc is c:
                        win_by_chr.append(
                            device_wlod.weighted_windows_device(
                                c, centro, wq, error, max_gap, use_gl,
                                mu, M, phased, sub_idx))
                    else:  # KDE individual subset: scores for cc, LD from c
                        ldm = device_wlod.ld_band_device(c, wq, phased,
                                                         sub_idx)
                        win_by_chr.append(device_wlod.wlod_windows_device(
                            cc, centro, ldm, wq, error, max_gap, use_gl,
                            mu, M))
                else:
                    ldm = ld_ops.calc_ld(c, wq, phased, sub_idx,
                                         engine=st.engine)
                    win_by_chr.append(wlod_ops.wlod_windows(
                        cc, centro, ldm, wq, error, max_gap, use_gl, mu, M))
            print(file=sys.stderr)
        else:
            win_by_chr = _calc_lod_windows(st, ds, centro, wq, error,
                                           max_gap, use_gl,
                                           ind_idx=None if sharded
                                           else ind_idx)
        kr = _compute_kde_for(st, win_by_chr, wq if thin else 1,
                              ind_idx if sharded else None, log,
                              exact=(wq, ind_idx))
        kdefile.write_kde(kr, kdefile.make_kde_filename(outfile, wq), log)
