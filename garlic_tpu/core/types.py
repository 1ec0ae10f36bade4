"""Columnar data model.

The reference keeps per-chromosome pointer-soup structs (HapData/MapData/
FreqData/GenoLikeData, src/garlic-data.h:32-108) laid out [loci][individuals].
Here everything is a dense numpy array laid out [individuals, loci] — the
individual axis is the data-parallel shard axis on a device mesh, and the locus
axis is the contiguous vector axis the kernels tile over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

MISSING = -9999  # sentinel for window scores / positions (src/garlic-data.h:24)
GENO_MISSING = -9  # genotype missing code (src/garlic-data.cpp:114-128)


class GarlicDataError(Exception):
    """Base for expected data-loading failures whose ERROR text has already
    been written to the .error log by the raiser (the reference's thrown
    ints caught as `catch(...) return 1`, src/garlic-main.cpp:210-242).
    The driver exits quietly on these; anything else is an internal bug and
    gets logged before the nonzero exit."""


class LocusNames:
    """Lazy '\\n'-joined locus-name buffer.

    The native TPED parser hands back one bytes blob per chromosome; most
    runs only ever need it verbatim (the native freq writer takes the raw
    buffer), so the 10^5-element Python list is materialized on first
    indexed access only."""

    __slots__ = ("raw", "_list")

    def __init__(self, raw: bytes):
        self.raw = raw
        self._list = None

    def _mat(self):
        if self._list is None:
            self._list = self.raw.decode().split("\n") if self.raw else []
        return self._list

    def __getitem__(self, i):
        return self._mat()[i]

    def __len__(self):
        if self._list is not None:
            return len(self._list)
        return (self.raw.count(b"\n") + 1) if self.raw else 0

    def __iter__(self):
        return iter(self._mat())


class ChromData:
    """All per-chromosome arrays.

    Genotypes may live purely in 2-bit packed form (`geno2b`, 4 loci/byte,
    code 3 = missing, tail codes past nloci = 3): the fast engine's
    panel-cache path filters, pads, and ships them packed, so the 4x
    larger int8 matrix never exists.  Reading `.genotypes` materializes
    the int8 view lazily (and caches it) for consumers that need it.

    `geno2b` itself may also be lazy (`geno2b_thunk`): the monomorphic
    filter defers the packed column compaction, because on a
    device-cache hit nothing on the host ever reads the filtered bytes
    — the content key (`geno2b_digest`, derived through the filter from
    the panel-cache sidecar's stored digest) is enough to find the
    payload already in HBM."""

    __slots__ = ("chrom", "positions", "gpos", "locus_names", "alleles",
                 "_geno", "freq", "first_copy", "_gl", "gl_codes", "gl_lut",
                 "_geno2b", "_geno2b_thunk", "_nind", "geno2b_digest",
                 "nind_total", "row0", "freq_num", "freq_den",
                 "geno2b_parent")

    def __init__(self, chrom: str, positions: np.ndarray, gpos: np.ndarray,
                 locus_names, alleles: np.ndarray,
                 genotypes: Optional[np.ndarray],
                 freq: Optional[np.ndarray] = None,
                 first_copy: Optional[np.ndarray] = None,
                 gl: Optional[np.ndarray] = None,
                 geno2b: Optional[np.ndarray] = None,
                 geno2b_thunk=None, nind: Optional[int] = None,
                 geno2b_digest: Optional[bytes] = None,
                 gl_codes: Optional[np.ndarray] = None,
                 gl_lut: Optional[np.ndarray] = None,
                 nind_total: Optional[int] = None, row0: int = 0,
                 freq_num: Optional[np.ndarray] = None,
                 freq_den: Optional[np.ndarray] = None):
        self.chrom = chrom                 # chr-prefixed name
        self.positions = positions         # int64 [L] physical bp
        self.gpos = gpos                   # float64 [L] genetic position
        self.locus_names = locus_names     # [L]
        self.alleles = alleles             # '<U1' [L]; the '1' allele
        self._geno = genotypes             # int8 [I, L] or None (packed)
        self.freq = freq                   # float64 [L]
        self.first_copy = first_copy       # bool [I, L] (phased only)
        self._gl = gl                      # float64 [I, L] TGLS errors
        self.gl_codes = gl_codes           # u8 [I, L] TGLS dict codes
        self.gl_lut = gl_lut               # f64 [K] converted error values
        self._geno2b = geno2b              # u8 [I, ceil(L/4)] 2-bit codes
        self._geno2b_thunk = geno2b_thunk  # 0-arg -> u8 [I, ceil(L/4)]
        self._nind = nind                  # required when both geno forms
        #                                    are lazy (thunk-only)
        self.geno2b_digest = geno2b_digest  # 16B content key or None
        # Per-host sharded input (multi-process column-range loads): the
        # genotype rows here are the global individual rows
        # [row0, row0 + nind); nind_total is the full panel width and
        # freq_num/freq_den are this host's partial '1'-allele /
        # observed-allele count planes (psum -> global freq).
        self.nind_total = nind_total       # None: rows ARE the full panel
        self.row0 = row0
        self.freq_num = freq_num
        self.freq_den = freq_den
        # (parent_packed_u8, kept_parent_col_idx): set by the monomorphic
        # filter when the column compaction is deferred — sparse consumers
        # (the tie patrol's suspect-window gather) decode the few bytes
        # they need straight from the UNFILTERED payload instead of
        # forcing the whole-matrix compaction thunk (~20 ms/chromosome on
        # warm WGS runs whose device-cache hit never needs the bytes)
        self.geno2b_parent = None

    @property
    def gl(self) -> Optional[np.ndarray]:
        """TGLS per-genotype error matrix [I, L] f64.  When the native
        TGLS reader stored the dictionary form (gl_codes + gl_lut), the
        double matrix materializes lazily here."""
        if self._gl is None and self.gl_codes is not None:
            self._gl = self.gl_lut[self.gl_codes]
        return self._gl

    @gl.setter
    def gl(self, v) -> None:
        self._gl = v

    @property
    def genotypes(self) -> np.ndarray:
        if self._geno is None:
            self._geno = _unpack_geno2b(self.geno2b, self.nloci)
        return self._geno

    @property
    def geno2b(self) -> Optional[np.ndarray]:
        if self._geno2b is None and self._geno2b_thunk is not None:
            self._geno2b = self._geno2b_thunk()
            self._geno2b_thunk = None
        return self._geno2b

    @property
    def geno_is_packed_only(self) -> bool:
        return self._geno is None and (self._geno2b is not None
                                       or self._geno2b_thunk is not None)

    @property
    def nloci(self) -> int:
        return int(self.positions.shape[0])

    @property
    def nind(self) -> int:
        if self._geno is not None:
            return int(self._geno.shape[0])
        if self._geno2b is not None:
            return int(self._geno2b.shape[0])
        return int(self._nind)

    @property
    def nind_global(self) -> int:
        """Full-panel individual count: == nind except on per-host
        column-range loads, where nind is only this host's row block."""
        return int(self.nind_total) if self.nind_total is not None \
            else self.nind


def _unpack_geno2b(packed: np.ndarray, L: int) -> np.ndarray:
    from garlic_tpu.native import unpack_2bit_native
    g = unpack_2bit_native(packed, L)
    if g is None:  # numpy fallback (several large temporaries)
        I = packed.shape[0]
        codes = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)],
                         axis=-1).reshape(I, -1)
        g = np.where(codes == 3, -9, codes).astype(np.int8)[:, :L]
    return g


@dataclass
class Dataset:
    chroms: List[ChromData] = field(default_factory=list)
    ind_ids: List[str] = field(default_factory=list)
    pop: str = ""
    # panel-cache sidecar backing this load (None when --tpu-panel-cache is
    # off): lets the freq writer reuse/refresh the cached .freq.gz blob
    panel_cache_file: str = None

    @property
    def nind(self) -> int:
        return len(self.ind_ids)

    @property
    def nloci(self) -> int:
        return sum(c.nloci for c in self.chroms)

    def subset_individuals(self, idx: np.ndarray) -> "Dataset":
        """Subset to the given individual indices (reference subsetData,
        src/garlic-data.cpp:2171-2244)."""
        out = Dataset(ind_ids=[self.ind_ids[i] for i in idx], pop=self.pop)
        for c in self.chroms:
            packed = c.geno_is_packed_only
            out.chroms.append(ChromData(
                chrom=c.chrom,
                positions=c.positions,
                gpos=c.gpos,
                locus_names=c.locus_names,
                alleles=c.alleles,
                genotypes=None if packed else c.genotypes[idx],
                freq=c.freq,
                first_copy=None if c.first_copy is None else c.first_copy[idx],
                gl=None if c._gl is None else c._gl[idx],
                gl_codes=None if c.gl_codes is None else c.gl_codes[idx],
                gl_lut=c.gl_lut,
                geno2b=c.geno2b[idx] if packed else None,
            ))
        return out
