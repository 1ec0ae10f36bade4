"""Device-resident Phase-I window matrices (fast engine runtime).

The reference materializes WinData (nind x nloci doubles) in host RAM and
every downstream phase walks it (src/garlic-data.h:73-79).  Here the
window matrix stays in device memory and only compact artifacts cross to
the host:

* thinned KDE samples          win[:, ::step]          ~ I x L/step  f32
* assembly coverage masks      packbits(covered)       ~ I x L/8     u8
* full matrix                  only for --raw-lod dumps

Coverage counting (assembleROHWindows' inWin accumulation,
src/garlic-roh.cpp:446-454) is a width-W sliding sum over the cutoff
indicator — the same shifted-add machinery as Phase I, on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

from ..core.types import MISSING

_warned_full_transfer = False


@dataclass
class DeviceWin:
    """One chromosome's f32 window-score matrix living on device.

    win is either [I', L'] (I' >= nind, L' >= nloci; MISSING beyond
    nwin = nloci - W + 1) or, when nwin is set, a bucketed [I2, NW2]
    matrix holding window-start columns only (NW2 >= nwin, MISSING past
    nwin).  Accessors always present the reference's [nind, nloci]
    MISSING-tailed view."""
    win: object
    nind: int
    nloci: int
    nwin: int = -1   # -1: win already spans nloci columns
    # tie-patrol band scale: f32 device scalar = max finite |window term|
    # (weighted paths, where 1/LD amplification makes a static bound
    # useless).  None = interpret assemble_roh's tie_delta as absolute.
    tie_scale: object = None

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def __getitem__(self, idx):
        # row access falls back to a full-matrix transfer (cached): fine
        # for --raw-lod dumps, a perf bug anywhere hot — warn once so a
        # careless caller cannot silently reintroduce the transfer this
        # design exists to avoid
        global _warned_full_transfer
        if not hasattr(self, "_host") and not _warned_full_transfer:
            _warned_full_transfer = True
            import sys
            print("[garlic-tpu] note: DeviceWin row access transfers the "
                  "full window matrix to host (expected for --raw-lod; "
                  "use thinned/covered accessors in hot paths)",
                  file=sys.stderr)
        return self.to_numpy()[idx]

    def to_numpy(self) -> np.ndarray:
        from ..parallel.multihost import to_host
        if not hasattr(self, "_host"):
            if self.nwin < 0:
                self._host = to_host(self.win).astype(
                    np.float64)[:self.nind, :self.nloci]
            else:
                host = np.full((self.nind, self.nloci), float(MISSING))
                src = to_host(self.win).astype(np.float64)
                host[:, :self.nwin] = src[:self.nind, :self.nwin]
                self._host = host
        return self._host


def is_device_win(obj) -> bool:
    return isinstance(obj, DeviceWin)


class LazyWin:
    """Rematerializable window matrix: holds a thunk instead of device
    memory.  A 22-chromosome x 1000-individual WGS panel's window
    matrices (~4 GB f32 each) cannot all live in HBM at once; consumers
    call make(), extract what they need (thinned samples / coverage
    bits), and drop the result — Phase-I compute runs at G-windows/s so
    recomputation costs less than the memory (SURVEY.md hard part e)."""

    __slots__ = ("_fn", "nind", "nloci")

    def __init__(self, fn, nind: int, nloci: int):
        self._fn = fn
        self.nind = nind
        self.nloci = nloci

    def make(self) -> DeviceWin:
        return self._fn()

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def __getitem__(self, idx):
        return self.make().to_numpy()[idx]


def is_lazy_win(obj) -> bool:
    return isinstance(obj, LazyWin)


def phase1_layout(nloci: int, winsize: int):
    """Bucketed Phase-I device layout (NW2, L2): window starts padded to
    a power of two (one compiled program per bucket serves every
    chromosome length), loci to NW2 plus a halo of >= W-1 (a multiple of
    128, so the 2-bit payload is whole bytes)."""
    from .device_cache import _bucket, _cdiv
    NW2 = _bucket(max(nloci - winsize + 1, 1))
    return NW2, NW2 + _cdiv(winsize - 1, 128) * 128


def _phase1_inputs(chrom, winsize: int, missing: np.ndarray, error: float):
    """Device inputs of the bucketed Phase-I programs: (packed [I, L2/4]
    u8 2-bit codes, table [3, L2] f32, missing [NW2] int8 — 1 past nwin).
    The genotype payload and both planes come from the content-keyed
    device caches, so a warm run uploads nothing."""
    from .device_cache import _decode_2bit, _device_plane, device_packed_keyed
    from .lod import lod_table
    L = chrom.nloci
    NW2, L2 = phase1_layout(L, winsize)
    nwin = L - winsize + 1
    pk, _ = device_packed_keyed(chrom)
    tp = np.zeros((3, L2), dtype=np.float32)
    tp[:, :L] = lod_table(chrom.freq, error)[:3]
    mp = np.ones(NW2, dtype=np.int8)
    mp[:nwin] = np.asarray(missing)[:nwin]
    return (_decode_2bit(pk, L, L2), _device_plane(tp),
            _device_plane(mp))


@partial(__import__("jax").jit, static_argnames=("winsize",))
def _packed_windows(packed, table, missing, winsize: int):
    """Bucketed Phase-I window scores [I, NW2] f32 (MISSING where
    missing != 0) from _phase1_inputs: unpack the 2-bit codes, select
    per-class table terms, shifted-add window sums (lod_windows_fast_jax's
    arithmetic on the bucketed layout)."""
    import jax.numpy as jnp

    from .lod import table_terms, window_sums_exact
    I, Lq = packed.shape
    parts = [(packed >> s) & 3 for s in (0, 2, 4, 6)]
    g = jnp.stack(parts, axis=-1).reshape(I, Lq * 4)
    NW2 = missing.shape[0]
    s = window_sums_exact(table_terms(g, table), winsize)[:, :NW2]
    return jnp.where(missing[None, :] != 0, jnp.float32(MISSING), s)


def lod_windows_device(chrom, centro, winsize: int, error: float,
                       max_gap: int, use_gl: bool) -> DeviceWin:
    """Phase-I fast path with NO host transfer (cf. ops.lod.calc_lod_windows
    which converts to f64 numpy)."""
    import jax.numpy as jnp

    from .lod import lod_windows_fast_gl, window_missing_mask

    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    nwin = max(chrom.nloci - winsize + 1, 0)
    if nwin == 0:
        win = jnp.full((chrom.nind, chrom.nloci), jnp.float32(MISSING))
        return DeviceWin(win=win, nind=chrom.nind, nloci=chrom.nloci)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    if use_gl:
        win = lod_windows_fast_gl(jnp.asarray(chrom.genotypes),
                                  jnp.asarray(chrom.freq),
                                  jnp.asarray(chrom.gl),
                                  jnp.asarray(missing), winsize)
        return DeviceWin(win=win, nind=chrom.nind, nloci=chrom.nloci)
    win = _packed_windows(*_phase1_inputs(chrom, winsize, missing, error),
                          winsize)
    return DeviceWin(win=win, nind=chrom.nind, nloci=chrom.nloci, nwin=nwin)


_thin_jit = None


def thinned_block(dwin: DeviceWin, step: int,
                  ind_idx=None) -> np.ndarray:
    """win[:, ::step] transferred to host ([I, ceil(L/step)] f64).

    This is convertWinData2DoubleData's thinning (src/garlic-data.cpp:2037)
    done as a jitted device slice so only 1/step of the matrix crosses the
    link (eager slicing would compile a fresh strided-slice per shape)."""
    global _thin_jit
    if _thin_jit is None:
        import jax

        @partial(jax.jit, static_argnames=("step",))
        def _thin(w, step):
            return w[:, ::step]

        _thin_jit = _thin
    from ..parallel.multihost import to_host
    out = to_host(_thin_jit(dwin.win, step)).astype(np.float64)
    out = out[:dwin.nind]  # drop mesh-padding rows (their windows are 0)
    if ind_idx is not None:
        out = out[ind_idx]
    return out


def _covered_kernel_factory():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("winsize",))
    def _covered(win, cutoff, threshold, delta, winsize: int):
        from .lod import window_sums_exact

        # win columns are window-start slots (possibly only nwin + bucket
        # padding wide); SNP s is covered by window starts in
        # [s - W + 1, s], so pad W-1 zeros on BOTH sides and the VALID
        # window sum yields coverage for SNPs 0..N+W-2 (>= nloci).
        # Shifted-add doubling keeps the counts integer-exact (true adds,
        # no convolution whose lowering may accumulate in low precision).
        # bf16 counts are exact integers <= 256 (see _cov_kernel_factory)
        cdt = jnp.bfloat16 if winsize <= 255 else jnp.float32
        # integer counts: >= t is >= ceil(t); ceil BEFORE the bf16 cast
        # (bf16 could round a fractional t DOWN onto an integer).
        # covered_dispatch already ceils — this keeps direct callers safe.
        threshold = jnp.ceil(threshold)
        above = (win >= cutoff).astype(cdt)
        sus = jnp.any(jnp.abs(win - cutoff) < delta, axis=1)  # tie patrol
        I, N = above.shape
        z = jnp.zeros((I, winsize - 1), cdt)
        padded = jnp.concatenate([z, above, z], axis=1)
        counts = window_sums_exact(padded, winsize)    # [I, N + W - 1]
        covered = counts >= jnp.asarray(threshold, cdt)
        # pack along loci: 8 SNP flags per byte for the host transfer
        outw = N + winsize - 1
        pad = (-outw) % 8
        cp = jnp.concatenate(
            [covered, jnp.zeros((I, pad), bool)], axis=1) if pad else covered
        # suspect flags ride the same transfer as a trailing byte column
        return jnp.concatenate(
            [jnp.packbits(cp, axis=1, bitorder="little"),
             sus[:, None].astype(jnp.uint8)], axis=1)

    return _covered


_covered_jit = None
_cov_jit = None
_edges_jit = None
_EDGE_BLOCK = 128      # SNPs per edge block
_EDGE_CAP = 1 << 14    # final-tier block cap before bitmap fallback
_EDGE_IDX_CAP = 1 << 16  # final-tier edge cap before bitmap fallback
# First-tier caps: the fused payload ships (2 + I + ecap) i32 slots, and
# real panels produce ~5k edges per 500k-SNP chromosome — an 8k tier is
# a ~34 KB transfer instead of the final tier's ~263 KB.  Overflow
# escalates to the final tier (one extra small round trip), then bitmap.
_EDGE_T1_CAP = 1 << 13
_EDGE_T1_IDX_CAP = 1 << 13
# Tie-patrol suspect-window caps: ~100 windows per 200-individual WGS
# chromosome in practice even with a pinned (non-density-minimum)
# cutoff; 1000-individual panels reach a few thousand.  Overflow falls
# back to row-level repair, whose [rows, L] exact recomputation is FAR
# costlier than the 64 KB of extra payload these caps ship.
_SUS_BLK_CAP = 4096
_SUS_IDX_CAP = 8192


def _edge_tiers(I: int = 256):
    """Edge-payload tiers, scaled by the row count: real panels produce
    ~25 edges/row, so caps tuned for ~200 rows make EVERY chromosome of
    a 1000-individual panel overflow — tier 1 into an escalation that
    re-executes the whole coverage program, and the FINAL tier into the
    bitmap fallback, whose I x outw/8 payload is ~134 MB per
    chromosome versus the few hundred KB these scaled caps ship.
    Upper bounds keep the gathered block matrix and
    index payload a few MB; panels beyond them genuinely belong on the
    bitmap path."""
    t2 = (min(max(_EDGE_CAP, 64 * I), 1 << 20),
          min(max(_EDGE_IDX_CAP, 256 * I), 1 << 20))
    t1 = (min(max(_EDGE_T1_CAP, 32 * I), t2[0]),
          min(max(_EDGE_T1_IDX_CAP, 64 * I), t2[1]))
    return (t1, t2) if t1 != t2 else (t2,)


_COV_BUCKET = 8192  # covered-width bucket: all winsizes of one panel
                    # share the edge-extract executable (see below)


def _cov_kernel_factory():
    """Coverage bits, bucketed: SNP s is covered when >= threshold
    cutoff-passing windows span it (assembleROHWindows' inWin
    accumulation, src/garlic-roh.cpp:446-454).  winsize is static (the
    exact shifted-add window sum unrolls over it) but this program is
    small to compile, unlike the edge extraction below, which is
    therefore kept winsize-independent behind a bucketed shape."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("winsize", "outw2"))
    def _cov(win, cutoff, threshold, delta, winsize: int, outw2: int):
        from .lod import window_sums_exact

        above = win >= cutoff
        # tie patrol: windows within delta of the cutoff (the f32 error
        # band) get their decision re-derived in f64 on the host — see
        # assemble_roh's exact_window/exact_cover.  MISSING slots are
        # -9999, far outside any band.  delta 0 flags nothing.
        susw = jnp.abs(win - cutoff) < delta
        sus = jnp.any(susw, axis=1)
        # bf16 counts: integers <= 256 are exact in bf16 (8 mantissa
        # bits), and winsize bounds every count — halves the memory
        # traffic of the O(log W) shifted-add passes, which dominate this
        # program at WGS scale.  Large winsizes keep f32.
        cdt = jnp.bfloat16 if winsize <= 255 else jnp.float32
        # integer counts: >= t is >= ceil(t); ceil BEFORE the bf16 cast
        # (covered_dispatch already ceils — this keeps direct callers safe)
        threshold = jnp.ceil(threshold)
        abf = above.astype(cdt)
        I, N = abf.shape
        z = jnp.zeros((I, winsize - 1), cdt)
        padded = jnp.concatenate([z, abf, z], axis=1)
        covered = window_sums_exact(padded, winsize) >= \
            jnp.asarray(threshold, cdt)
        outw = N + winsize - 1
        if outw2 > outw:
            covered = jnp.concatenate(
                [covered, jnp.zeros((I, outw2 - outw), bool)], axis=1)
        return covered, sus, susw, above

    return _cov


def _edges_kernel_factory():
    """Block-sparse exact edge extraction: ROH coverage is long runs, so
    the 0->1/1->0 transition bitmap is extremely sparse.  Two-stage
    compaction keeps both nonzeros small: a per-128-SNP-block any()
    summary (one cheap reduce) feeds a nonzero over I x nb elements, the
    nonempty blocks' bits are gathered, and a second nonzero over
    cap x 128 yields EXACT global edge indices.  Everything (counts, the
    row-tail flags, the indices) is fused into ONE i32 array so a single
    D2H round trip (~34 KB tier 0) replaces per-array fetches of packed
    block bitmaps.

    The program takes the bucketed covered matrix plus a TRACED true
    width `outw`, so its XLA compile is paid once per (I, bucket) shape
    rather than once per winsize (an --auto-winsize search or a winsize
    sweep would otherwise recompile it per candidate).

    Compactions use cumsum + vectorized binary search instead of
    jnp.nonzero, which scans its whole input serially: cumsum is one
    data-parallel pass and searchsorted('scan') is ~log2(n) vectorized
    gather rounds over only `size` queries — the same indices
    bit-for-bit."""
    import jax
    import jax.numpy as jnp

    def _nz(mask_flat, size: int):
        """jnp.nonzero(mask, size=size, fill_value=-1)[0] as int32, via
        cumsum + binary search (see factory docstring)."""
        c = jnp.cumsum(mask_flat.astype(jnp.int32))
        q = jnp.arange(1, size + 1, dtype=jnp.int32)
        idx = jnp.searchsorted(c, q, side="left").astype(jnp.int32)
        return jnp.where(q <= c[-1], idx, -1)

    @partial(jax.jit, static_argnames=("cap", "block", "ecap"))
    def _edges(covered, sus, susw, above, outw, cap: int, block: int,
               ecap: int):
        # optimization_barrier between the dense stages and each sparse
        # compaction: without them XLA may fuse the dense producers into
        # the gather consumer loops and recompute them per element
        covered = jax.lax.optimization_barrier(covered)
        I, OUTW2 = covered.shape
        prev = jnp.concatenate(
            [jnp.zeros((I, 1), bool), covered[:, :-1]], axis=1)
        edge = covered != prev
        # mask pad-region transitions: a run reaching outw-1 would
        # otherwise record a closing edge at column outw, whose flat
        # index collides with the next row's column 0 (trailing runs are
        # closed host-side via the `last` flags instead)
        edge = edge & (jnp.arange(OUTW2, dtype=jnp.int32)[None, :] < outw)
        nb = OUTW2 // block  # OUTW2 is a block multiple by construction
        eb = edge.reshape(I * nb, block)
        summary = jnp.any(eb, axis=1)
        nblk = jnp.sum(summary).astype(jnp.int32)
        nedge = jnp.sum(eb).astype(jnp.int32)
        eb, summary = jax.lax.optimization_barrier((eb, summary))
        bidx = _nz(summary, cap)
        gb = eb[jnp.maximum(bidx, 0)] & (bidx >= 0)[:, None]
        gb = jax.lax.optimization_barrier(gb)
        loc = _nz(gb.reshape(-1), ecap)
        bid = bidx[jnp.maximum(loc // block, 0)]
        # blocks ascend row-major, offsets ascend within each block, so
        # gidx is globally sorted ascending (what _edges_to_packed needs)
        gidx = jnp.where(
            loc >= 0,
            (bid // nb) * outw + (bid % nb) * block + loc % block,
            -1).astype(jnp.int32)
        last = jax.lax.dynamic_slice(covered, (0, outw - 1), (I, 1))[:, 0]
        # suspect-window extraction (tie patrol): same two-stage
        # block-sparse compaction as the edges, much sparser in practice
        # (the cutoff sits at or near a window-value density minimum).
        # Ships exact flat indices + the f32 side of each, so the host
        # can verify ~100 decisions in f64 instead of recomputing whole
        # rows.  Overflow (> _SUS_IDX_CAP) degrades to row-level repair.
        IN, NW = susw.shape
        NWp = -(-NW // block) * block
        if NWp != NW:  # tests feed unbucketed widths; pipeline pads
            susw = jnp.concatenate(
                [susw, jnp.zeros((IN, NWp - NW), bool)], axis=1)
        nbs = NWp // block
        sb = susw.reshape(IN * nbs, block)
        ssum = jnp.any(sb, axis=1)
        nsusw = jnp.sum(sb).astype(jnp.int32)
        # nonempty suspect BLOCK count: when it exceeds _SUS_BLK_CAP the
        # bidx gather drops blocks, so sgidx would hold -1 fills inside
        # its first nsusw entries even though nsusw <= _SUS_IDX_CAP —
        # the host must see the overflow to degrade to row-level repair
        nsblk = jnp.sum(ssum).astype(jnp.int32)
        sb, ssum = jax.lax.optimization_barrier((sb, ssum))
        sbidx = _nz(ssum, _SUS_BLK_CAP)
        sgb = sb[jnp.maximum(sbidx, 0)] & (sbidx >= 0)[:, None]
        sgb = jax.lax.optimization_barrier(sgb)
        sloc = _nz(sgb.reshape(-1), _SUS_IDX_CAP)
        sbid = sbidx[jnp.maximum(sloc // block, 0)]
        # flat indices in the UNPADDED [I, NW] space (pad cols are never
        # suspect, so every real hit's column is < NW)
        sgidx = jnp.where(
            sloc >= 0,
            (sbid // nbs) * NW + (sbid % nbs) * block + sloc % block,
            -1).astype(jnp.int32)
        sside = jnp.where(
            sgidx >= 0, above.reshape(-1)[jnp.maximum(sgidx, 0)],
            False).astype(jnp.int32)
        out = jnp.concatenate([
            jnp.stack([nblk, nedge, nsusw, nsblk]),
            last.astype(jnp.int32),
            sus.astype(jnp.int32),
            sgidx,
            sside,
            gidx])
        return out

    return _edges


def _set_bits(row: np.ndarray, o: int, c: int) -> None:
    """Set little-endian bits [o, c) in a packed u8 row."""
    if c <= o:
        return
    bo, bc = o >> 3, c >> 3
    if bo == bc:
        row[bo] |= ((0xFF << (o & 7)) & 0xFF) & (0xFF >> (8 - (c & 7)))
        return
    if o & 7:
        row[bo] |= (0xFF << (o & 7)) & 0xFF
        bo += 1
    row[bo:bc] = 0xFF
    if c & 7:
        row[bc] |= 0xFF >> (8 - (c & 7))


def _edges_to_packed(idx: np.ndarray, last: np.ndarray, I: int,
                     outw: int) -> np.ndarray:
    """Reconstruct the bit-packed coverage matrix from run edges.

    idx: sorted flat indices of 0->1/1->0 transitions (row-major over
    [I, outw]); last: [I] bool, True when the row's final SNP is covered
    (closes the trailing run at outw)."""
    row_bytes = (outw + 7) // 8
    out = np.zeros((I, row_bytes), np.uint8)
    rows = idx // outw
    cols = idx % outw
    bounds = np.searchsorted(rows, np.arange(I + 1))
    for i in range(I):
        e = cols[bounds[i]:bounds[i + 1]]
        if last[i]:
            e = np.append(e, outw)
        for k in range(0, e.shape[0] - 1, 2):
            _set_bits(out[i], int(e[k]), int(e[k + 1]))
    return out


def covered_dispatch(dwin: DeviceWin, cutoff: float, winsize: int,
                     threshold: float, tie_delta: float = 0.0):
    """Enqueue the coverage extraction on device and return a handle for
    covered_fetch.  Dispatch/fetch are split so the assembly driver can
    enqueue EVERY chromosome's kernels before the first blocking fetch —
    chromosome N+1's device compute then overlaps chromosome N's host-side
    reconstruction and run scan.

    tie_delta > 0 additionally flags rows holding any window within
    tie_delta of the cutoff (the f32 error band); the flags ride the
    same D2H payload and covered_fetch returns them alongside the bits.
    When the DeviceWin carries a tie_scale (weighted paths), tie_delta
    is a FACTOR multiplied by that device scalar — no host sync."""
    global _covered_jit, _edges_jit
    import os

    import jax.numpy as jnp

    if tie_delta and getattr(dwin, "tie_scale", None) is not None:
        tie_delta = jnp.float32(tie_delta) * dwin.tie_scale
    # coverage counts are exact integers, so `count >= threshold` over
    # f64 equals `count >= ceil(threshold)` — which is f32-exact, unlike
    # a cast of e.g. 0.33*60 whose f32 rounding could straddle an integer
    import math
    threshold = float(math.ceil(threshold))
    I, N = dwin.win.shape
    outw = N + winsize - 1
    mode = os.environ.get("GARLIC_TPU_COVERED", "auto")
    if I * outw >= 2**31:
        mode = "bitmap"  # flat i32 edge indices would overflow
    if mode != "bitmap":
        return _dispatch_edges(dwin, cutoff, winsize, threshold, tie_delta,
                               0)
    if _covered_jit is None:
        _covered_jit = _covered_kernel_factory()
    packed = _covered_jit(dwin.win, jnp.float32(cutoff),
                          jnp.float32(threshold), jnp.float32(tie_delta),
                          winsize)
    _start_host_copy(packed)
    return ("bitmap", dwin, cutoff, winsize, threshold, tie_delta, packed)


def _dispatch_edges(dwin: DeviceWin, cutoff: float, winsize: int,
                    threshold: float, tie_delta: float, tier: int):
    """Enqueue the XLA coverage program and the edge extraction on its
    outputs for one DeviceWin at edge-payload tier `tier`."""
    global _cov_jit, _edges_jit
    import jax.numpy as jnp

    if _edges_jit is None:
        _edges_jit = _edges_kernel_factory()
    if _cov_jit is None:
        _cov_jit = _cov_kernel_factory()
    I, N = dwin.win.shape
    cap, icap = _edge_tiers(I)[tier]
    outw = N + winsize - 1
    outw2 = -(-outw // _COV_BUCKET) * _COV_BUCKET
    covered, sus, susw, above = _cov_jit(dwin.win, jnp.float32(cutoff),
                                         jnp.float32(threshold),
                                         jnp.float32(tie_delta), winsize,
                                         outw2)
    fused = _edges_jit(covered, sus, susw, above, jnp.int32(outw), cap,
                       _EDGE_BLOCK, icap)
    _start_host_copy(fused)
    return ("edges", dwin, cutoff, winsize, threshold, tie_delta,
            (fused, I, N, outw, tier))


def _start_host_copy(arr) -> None:
    """Begin the D2H transfer now (non-blocking) so every dispatched
    chromosome's copy is in flight before the first blocking fetch —
    transfers overlap each other and the host-side run scans instead of
    serializing one link round trip per chromosome.  Skipped for
    non-fully-addressable (multi-host) arrays: covered_fetch gathers
    those via process_allgather, which would not consume this copy —
    the bytes would cross the host link twice for nothing."""
    try:
        if getattr(arr, "is_fully_addressable", False):
            arr.copy_to_host_async()
    except AttributeError:
        pass  # non-jax array (tests) or backend without async copies


def covered_fetch(handle):
    """Transfer + reconstruct (packed coverage bits, suspect-row flags,
    suspect-window detail) for a handle from covered_dispatch (falls back
    to the bitmap when the block-sparse edge extraction overflowed a
    cap).  The edges path is ONE D2H transfer:
    [nblk, nedge, nsusw, nsblk, last(I), sus(I), sgidx(SCAP), sside(SCAP),
    gidx(ecap)] i32; the bitmap path carries the row flags as a trailing
    byte column (no window detail: row-level repair applies there).

    The window detail is (rows, wins, f32_above) arrays or None when the
    suspect count overflowed _SUS_IDX_CAP or the nonempty suspect block
    count overflowed _SUS_BLK_CAP (blocks past the cap are dropped by the
    gather, so their suspects would silently never be re-derived)."""
    global _covered_jit
    import jax.numpy as jnp

    from ..parallel.multihost import to_host

    kind, dwin, cutoff, winsize, threshold, tie_delta, data = handle
    if kind == "edges":
        fused, I, N, outw, tier = data
        m = to_host(fused)
        tiers = _edge_tiers(I)
        cap, icap = tiers[tier]
        nblk, nedge = int(m[0]), int(m[1])
        nsusw, nsblk = int(m[2]), int(m[3])
        if nblk <= cap and nedge <= icap:
            o = 4
            last = m[o:o + I].astype(bool)
            sus = m[o + I:o + 2 * I].astype(bool)
            o += 2 * I
            susw = None
            if nsusw <= _SUS_IDX_CAP and nsblk <= _SUS_BLK_CAP:
                sgidx = m[o:o + nsusw].astype(np.int64)
                sside = m[o + _SUS_IDX_CAP:
                          o + _SUS_IDX_CAP + nsusw].astype(bool)
                if (sgidx >= 0).all():
                    susw = (sgidx // N, sgidx % N, sside)
                # else: defensive — a -1 fill inside the first nsusw
                # entries means dropped suspects; degrade to row repair
            o += 2 * _SUS_IDX_CAP
            idx = m[o:o + nedge].astype(np.int64)
            return _edges_to_packed(idx, last, I, outw), sus, susw
        if tier + 1 < len(tiers):  # escalate: one extra small round trip
            return covered_fetch(_dispatch_edges(
                dwin, cutoff, winsize, threshold, tie_delta, tier + 1))
        if _covered_jit is None:
            _covered_jit = _covered_kernel_factory()
        data = _covered_jit(dwin.win, jnp.float32(cutoff),
                            jnp.float32(threshold),
                            jnp.float32(tie_delta), winsize)
    m = to_host(data)
    return np.ascontiguousarray(m[:, :-1]), m[:, -1].astype(bool), None


def covered_packed(dwin: DeviceWin, cutoff: float, winsize: int,
                   threshold: float, tie_delta: float = 0.0):
    """(uint8 [I, ceil(L/8)] little-endian bit-packed coverage flags,
    bool [I] tie-suspect row flags, suspect-window detail or None).

    bit w = coverage_counts >= threshold at SNP w; MISSING window slots
    score -9999 < cutoff, so they never count — same comparison the
    reference performs (src/garlic-roh.cpp:446-448).

    Transfer strategy: ROH coverage is long runs, so by default the
    device extracts run edges block-sparsely (per-1024-SNP any() summary,
    small nonzero, gather of nonempty blocks) and ~2 MB crosses the link
    instead of the I x L/8 bitmap — cheaper than the bitmap on any link
    and ~20x cheaper than a full-length nonzero.  Falls back to the
    bitmap when a pathological panel overflows the block cap
    (GARLIC_TPU_COVERED=bitmap forces the old path)."""
    return covered_fetch(covered_dispatch(dwin, cutoff, winsize, threshold,
                                          tie_delta))


def covered_mask(dwin: DeviceWin, cutoff: float, winsize: int,
                 threshold: float) -> np.ndarray:
    """bool [I, L] unpacked coverage flags (see covered_packed)."""
    host, _, _ = covered_packed(dwin, cutoff, winsize, threshold)
    bits = np.unpackbits(host, axis=1, bitorder="little")
    return bits[:, :dwin.nloci].astype(bool)
