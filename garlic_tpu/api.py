"""Programmatic API: the four-phase ROH pipeline as Python calls.

The reference is CLI-only; this facade exposes the same computation to
notebooks/services without the file-output ceremony:

    from garlic_tpu import api
    ds = api.load_panel("data.tped.gz", "data.tfam")
    res = api.call_roh(ds, winsize=60, error=0.001)
    res.cutoff, res.bounds, res.calls[0].calls[:3]

Every knob mirrors the CLI flag of the same name; defaults match
src/garlic-cli.cpp.  Engines: "exact" (f64, reference-identical) or
"fast" (f32 device path); `mesh` accepts a jax.sharding.Mesh for SPMD runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .centromeres import Centromere
from .core.types import Dataset
from .io import filters, genmap, tfam as tfam_io, tgls as tgls_io, tped as tped_io
from .logger import RunLog
from .ops import assembly, convert, cutoff as cutoff_ops, gmm
from .ops import kde as kde_ops
from .ops import lod as lod_ops


@dataclass
class ROHResult:
    calls: List[assembly.IndividualROH]
    lengths: np.ndarray
    cutoff: float
    bounds: List[float]
    winsize: int
    kde: Optional[kde_ops.KDEResult] = None
    chrom_names: List[str] = field(default_factory=list)

    def to_rows(self):
        """Flat (ind_id, chrom, start, stop, size, size_class) tuples."""
        out = []
        for rec in self.calls:
            for c in rec.calls:
                cls = "A"
                for b in self.bounds:
                    if c.size > b:
                        cls = chr(ord(cls) + 1)
                out.append((rec.ind_id, self.chrom_names[c.chrom_idx],
                            c.start, c.stop, c.size, cls))
        return out


def load_panel(tped: str, tfam: str, tgls: Optional[str] = None,
               gl_type: str = "GQ", tped_missing: str = "0",
               mapfile: Optional[str] = None, build: str = "hg19",
               centromere_file: Optional[str] = None,
               phased: bool = False,
               seed: Optional[int] = None,
               panel_cache: bool = False) -> Dataset:
    """Load and filter a panel (TPED/TFAM + optional TGLS / genetic map).

    Monomorphic (and, with a map, out-of-bounds) sites are dropped, and
    genetic positions interpolated, exactly as the CLI pipeline does.
    panel_cache=True round-trips the parses through the .gtpc/.gtlc
    sidecars (the CLI's --tpu-panel-cache)."""
    log = RunLog()
    rng = np.random.default_rng(seed)
    centro = Centromere(build if not centromere_file else "none",
                        centromere_file or "none", "none", log)
    ds, _ = tped_io.load_tped(tped, tped_missing, 0, phased, True, log, rng,
                              panel_cache=panel_cache)
    ds.ind_ids, ds.pop = tfam_io.read_tfam(tfam, log)
    if tgls:
        tgls_io.read_tgls(tgls, ds.chroms, ds.nind, gl_type, log,
                          panel_cache=panel_cache)
        ds._use_gl = True
    else:
        ds._use_gl = False
    if mapfile:
        scaffolds = genmap.load_map_scaffold(mapfile, centro, log)
        ds.chroms, _ = filters.filter_monomorphic_and_oob(ds.chroms,
                                                          scaffolds)
        for c, s in zip(ds.chroms, scaffolds):
            c.gpos, _ = genmap.interpolate_genetic_map(c.positions, s)
    else:
        ds.chroms, _ = filters.filter_monomorphic(ds.chroms)
    ds._centro = centro
    return ds


def call_roh(ds: Dataset, winsize: int = 60, error: float = 0.001,
             max_gap: int = 200000, overlap_frac: float = 0.25,
             cutoff: Optional[float] = None,
             bounds: Optional[List[float]] = None, nclust: int = 3,
             kde_thin: bool = True, cm: bool = False,
             engine: str = "exact", mesh=None) -> ROHResult:
    """Phases I-IV on a loaded panel.  cutoff/bounds default to automatic
    discovery (KDE min-between-modes / GMM intersections)."""
    centro = getattr(ds, "_centro", None) or Centromere(
        "hg19", "none", "none", RunLog())
    use_gl = getattr(ds, "_use_gl", False)
    if engine == "fast":
        from .runtime import enable_compile_cache
        enable_compile_cache()

    win_by_chr = []
    for c in ds.chroms:
        if engine == "fast" and mesh is not None and not use_gl:
            from .parallel.engine import lod_windows_sharded
            win_by_chr.append(lod_windows_sharded(
                c, centro, winsize, error, max_gap, mesh))
        elif engine == "fast":
            from .ops import device_win
            win_by_chr.append(device_win.lod_windows_device(
                c, centro, winsize, error, max_gap, use_gl))
        else:
            win_by_chr.append(lod_ops.calc_lod_windows(
                c, centro, winsize, error, max_gap, use_gl, engine=engine))

    kr = None
    if cutoff is None:
        samples = convert.win_to_samples(
            win_by_chr, winsize if kde_thin else 1)
        kr = kde_ops.compute_kde(samples, device=(engine == "fast"))
        cutoff = cutoff_ops.get_min_btw_modes(kr.x, kr.y, winsize)

    calls, lengths = assembly.assemble_roh(
        win_by_chr, ds.chroms, ds.ind_ids, centro, cutoff, winsize,
        max_gap, overlap_frac, cm)

    if bounds is None:
        bounds, _ = gmm.select_size_classes(lengths, nclust)
    return ROHResult(calls=calls, lengths=lengths, cutoff=float(cutoff),
                     bounds=list(bounds), winsize=winsize, kde=kr,
                     chrom_names=[c.chrom for c in ds.chroms])
