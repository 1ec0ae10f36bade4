"""On-demand compilation + ctypes bindings for the native host kernels."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "garlic_native.cpp")
_SO = os.path.join(_HERE, "_garlic_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", "-o", _SO, _SRC, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return _SO
    except Exception:
        try:  # retry without OpenMP
            cmd = ["g++", "-O3", "-fPIC", "-shared", "-o", _SO, _SRC, "-lz"]
            subprocess.run(cmd, check=True, capture_output=True)
            return _SO
        except Exception:
            return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GARLIC_TPU_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.gt_tped_open.restype = ctypes.c_void_p
        lib.gt_tped_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                     ctypes.c_int]
        lib.gt_tped_open_range.restype = ctypes.c_void_p
        lib.gt_tped_open_range.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                           ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int64]
        lib.gt_tped_nind_total.restype = ctypes.c_int64
        lib.gt_tped_nind_total.argtypes = [ctypes.c_void_p]
        lib.gt_tped_col0.restype = ctypes.c_int64
        lib.gt_tped_col0.argtypes = [ctypes.c_void_p]
        lib.gt_tped_copy_counts.restype = ctypes.c_int
        lib.gt_tped_copy_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.gt_tped_nchrom.restype = ctypes.c_int
        lib.gt_tped_nchrom.argtypes = [ctypes.c_void_p]
        lib.gt_tped_nind.restype = ctypes.c_int64
        lib.gt_tped_nind.argtypes = [ctypes.c_void_p]
        lib.gt_tped_nloci.restype = ctypes.c_int64
        lib.gt_tped_nloci.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_chrom_name.restype = ctypes.c_char_p
        lib.gt_tped_chrom_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_names_size.restype = ctypes.c_int64
        lib.gt_tped_names_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_copy.restype = None
        lib.gt_tped_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p]
        lib.gt_tped_close.restype = None
        lib.gt_tped_close.argtypes = [ctypes.c_void_p]
        lib.gt_tped_copy_2bit.restype = None
        lib.gt_tped_copy_2bit.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p]
        lib.gt_gsl_sd.restype = ctypes.c_double
        lib.gt_gsl_sd.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
        lib.gt_lod_windows_exact.restype = None
        lib.gt_lod_windows_exact.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_write_freq_chrom.restype = ctypes.c_int
        lib.gt_write_freq_chrom.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.gt_read_freq.restype = ctypes.c_int
        lib.gt_read_freq.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_lod_windows_exact_tbl.restype = None
        lib.gt_lod_windows_exact_tbl.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        lib.gt_lod_windows_exact_thin.restype = None
        lib.gt_lod_windows_exact_thin.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_filter_columns.restype = ctypes.c_int64
        lib.gt_filter_columns.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.gt_covered_pack.restype = None
        lib.gt_covered_pack.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.gt_pack_2bit.restype = None
        lib.gt_pack_2bit.argtypes = [ctypes.POINTER(ctypes.c_int8),
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_int64]
        lib.gt_hash128.restype = None
        lib.gt_hash128.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_uint64)]
        lib.gt_filter_pack_2bit.restype = ctypes.c_int64
        lib.gt_filter_pack_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.gt_repad_2bit.restype = None
        lib.gt_repad_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64]
        lib.gt_unpack_2bit.restype = None
        lib.gt_unpack_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int8)]
        lib.gt_set_threads.restype = None
        lib.gt_set_threads.argtypes = [ctypes.c_int]
        lib.gt_get_max_threads.restype = ctypes.c_int
        lib.gt_get_max_threads.argtypes = []
        lib.gt_assemble_runs.restype = ctypes.c_int64
        lib.gt_assemble_runs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.gt_tgls_open.restype = ctypes.c_void_p
        lib.gt_tgls_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.gt_tgls_dict.restype = ctypes.c_int
        lib.gt_tgls_dict.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_nrows.restype = ctypes.c_int64
        lib.gt_tgls_nrows.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_nlut.restype = ctypes.c_int64
        lib.gt_tgls_nlut.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_bad_row.restype = ctypes.c_int64
        lib.gt_tgls_bad_row.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_bad_cols.restype = ctypes.c_int64
        lib.gt_tgls_bad_cols.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_get_lut.restype = None
        lib.gt_tgls_get_lut.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_double)]
        lib.gt_tgls_copy_codes.restype = None
        lib.gt_tgls_copy_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gt_tgls_copy_vals.restype = None
        lib.gt_tgls_copy_vals.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_tgls_close.restype = None
        lib.gt_tgls_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_tgls_native(path: str, nind: int, row_counts):
    """Parse a TGLS file via the C++ reader (chunked gz + parallel
    tokenize + token dictionary; reference: readTGLSData,
    src/garlic-data.cpp:1516-1586).  Returns None when the native
    library is unavailable or the file cannot be opened (callers fall
    back to the Python reader).  Otherwise one of:

      {"bad_cols": N} — the first row the reference would read had N
         columns instead of nind+4 (a truncated file reads as 0, like
         the Python reader's ''.split()).
      {"mode": "codes", "lut": f64 [K] raw token values,
       "chroms": [u8 [nind, L] code matrices]} — dictionary mode.
      {"mode": "vals", "chroms": [f64 [nind, L]]} — fallback (the file
         has > 255 distinct tokens or tokens > 16 chars)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.gt_tgls_open(path.encode(), int(nind))
    if not h:
        return None
    try:
        needed = int(sum(int(x) for x in row_counts))
        bad_row = int(lib.gt_tgls_bad_row(h))
        nrows = int(lib.gt_tgls_nrows(h))
        if 0 <= bad_row < needed:
            return {"bad_cols": int(lib.gt_tgls_bad_cols(h))}
        if nrows < needed:
            return {"bad_cols": 0}
        out = []
        row0 = 0
        if lib.gt_tgls_dict(h):
            k = int(lib.gt_tgls_nlut(h))
            lut = np.empty(k, dtype=np.float64)
            lib.gt_tgls_get_lut(
                h, lut.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            for L in row_counts:
                codes = np.empty((int(nind), int(L)), dtype=np.uint8)
                lib.gt_tgls_copy_codes(
                    h, row0, int(L),
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                out.append(codes)
                row0 += int(L)
            return {"mode": "codes", "lut": lut, "chroms": out}
        for L in row_counts:
            vals = np.empty((int(nind), int(L)), dtype=np.float64)
            lib.gt_tgls_copy_vals(
                h, row0, int(L),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out.append(vals)
            row0 += int(L)
        return {"mode": "vals", "chroms": out}
    finally:
        lib.gt_tgls_close(h)


def filter_pack_2bit_native(packed: np.ndarray, L: int, keep: np.ndarray):
    """Column-compact a packed [I, rb] genotype matrix by keep[L]; returns
    ([I, ceil(nkeep/4)] u8, nkeep) or None if the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    I, rb = p.shape
    k = np.ascontiguousarray(keep, dtype=np.uint8)
    nkeep = int(np.count_nonzero(k))
    rb_out = max((nkeep + 3) // 4, 1)
    out = np.empty((I, rb_out), dtype=np.uint8)
    lib.gt_filter_pack_2bit(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I, L, rb,
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rb_out)
    return out, nkeep


def repad_2bit_native(packed: np.ndarray, I2: int, rb2: int):
    """Pad a packed [I, rb] matrix to [I2, rb2] with missing (0xFF) fill;
    None if the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    I, rb = p.shape
    out = np.empty((I2, rb2), dtype=np.uint8)
    lib.gt_repad_2bit(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I, rb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I2, rb2)
    return out


def unpack_2bit_native(packed: np.ndarray, L: int):
    """[I, row_bytes] u8 2-bit codes -> [I, L] int8 (0/1/2/-9) in one C++
    pass; None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    I, rb = p.shape
    out = np.empty((I, L), dtype=np.int8)
    lib.gt_unpack_2bit(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I, L, rb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def gsl_sd_native(x: np.ndarray) -> Optional[float]:
    """gsl_stats_sd with GSL's exact FP semantics (80-bit x87 running-mean
    recurrences; see gt_gsl_sd) — the reference's nrd0 bandwidth input
    (src/garlic-kde.cpp:130-140).  None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.shape[0] < 2:
        return 0.0
    return float(lib.gt_gsl_sd(x, x.shape[0]))


def set_native_threads(n: int) -> None:
    """Cap the native library's OpenMP fan-out at n workers (--threads N,
    matching the reference's fixed thread count, src/garlic-roh.cpp:184-194).
    No-op when n <= 0 or the library is unavailable."""
    lib = _load()
    if lib is not None and n > 0:
        lib.gt_set_threads(int(n))


def get_native_max_threads() -> int:
    """Current OpenMP worker cap (1 if the library is unavailable)."""
    lib = _load()
    return int(lib.gt_get_max_threads()) if lib is not None else 1


def parse_tped_native(path: str, missing: str, want_fc: bool = True,
                      want_packed: bool = False,
                      col_range=None) -> Optional[List[dict]]:
    """Parse a TPED via the C++ parser.  Returns per-chromosome dicts or
    None if the native library is unavailable (callers fall back).
    want_fc=False skips the phased first-copy matrix (halves the
    transpose/copy work; unphased runs never read it).
    want_packed=True emits genotypes straight as 2-bit codes (fused
    transpose+pack, 4x fewer bytes written; the int8 matrix never
    exists) — the fast-engine unphased path; implies want_fc=False.
    col_range=(col0, col1) stores only that genotype column slice
    (per-host sharded input): allele coding stays full-row exact and each
    chromosome dict additionally carries partial 'freq_num'/'freq_den'
    count planes over the stored range plus 'nind_total'/'row0'."""
    lib = _load()
    if lib is None:
        return None
    if want_packed:
        want_fc = False
    if col_range is None:
        h = lib.gt_tped_open(path.encode(), missing.encode()[0:1] or b"0",
                             1 if want_fc else 0)
    else:
        h = lib.gt_tped_open_range(
            path.encode(), missing.encode()[0:1] or b"0",
            1 if want_fc else 0, int(col_range[0]), int(col_range[1]))
    if not h:
        raise IOError(f"native TPED parse failed for {path}")
    try:
        nchrom = lib.gt_tped_nchrom(h)
        nind = lib.gt_tped_nind(h)
        nind_total = lib.gt_tped_nind_total(h)
        row0 = lib.gt_tped_col0(h)
        out = []
        for c in range(nchrom):
            L = lib.gt_tped_nloci(h, c)
            name = lib.gt_tped_chrom_name(h, c).decode()
            nsz = lib.gt_tped_names_size(h, c)
            positions = np.empty(L, dtype=np.int64)
            gpos = np.empty(L, dtype=np.float64)
            alleles = np.empty(L, dtype="S1")
            freq = np.empty(L, dtype=np.float64)
            names_buf = ctypes.create_string_buffer(int(nsz) + 1)
            geno = None
            geno2b = None
            fc = None
            if want_packed:
                rb = (int(L) + 3) // 4
                geno2b = np.empty((nind, rb), dtype=np.uint8)
                lib.gt_tped_copy_2bit(
                    h, c,
                    positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    gpos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    alleles.ctypes.data_as(ctypes.c_char_p),
                    geno2b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    rb,
                    freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    names_buf)
            else:
                geno = np.empty((nind, L), dtype=np.int8)
                fc = np.empty((nind, L), dtype=np.uint8) if want_fc else None
                lib.gt_tped_copy(
                    h, c,
                    positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    gpos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    alleles.ctypes.data_as(ctypes.c_char_p),
                    geno.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    fc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                    if fc is not None else None,
                    freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    names_buf)
            fnum = fden = None
            if col_range is not None:
                fnum = np.empty(L, dtype=np.float64)
                fden = np.empty(L, dtype=np.float64)
                ok = lib.gt_tped_copy_counts(
                    h, c,
                    fnum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    fden.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
                if not ok:
                    fnum = fden = None
            from ..core.types import LocusNames
            out.append({
                "chrom": name,
                "positions": positions,
                "gpos": gpos,
                "alleles": alleles.astype("<U1"),
                "genotypes": geno,
                "geno2b": geno2b,
                "first_copy": fc.view(np.bool_) if fc is not None else None,
                "freq": freq,
                "freq_num": fnum,
                "freq_den": fden,
                "nind_total": int(nind_total),
                "row0": int(row0),
                "names": LocusNames(names_buf.raw[:nsz]),
            })
        return out
    finally:
        lib.gt_tped_close(h)


def covered_pack_native(win: np.ndarray, winsize: int, cutoff: float,
                        threshold: float):
    """One-pass coverage+threshold+packbits over a f64 [I, L] window
    matrix; None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    w = np.ascontiguousarray(win, dtype=np.float64)
    I, L = w.shape
    row_bytes = (L + 7) // 8
    out = np.empty((I, row_bytes), dtype=np.uint8)
    lib.gt_covered_pack(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), I, L, winsize,
        float(cutoff), float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), row_bytes)
    return out


def filter_columns_native(arr: np.ndarray, keep: np.ndarray):
    """In-place column compaction; returns a [:, :nkeep] view or None if
    the native lib is unavailable.  arr must be C-contiguous [I, L]."""
    lib = _load()
    if lib is None or not arr.flags.c_contiguous:
        return None
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    I, L = arr.shape
    nkeep = lib.gt_filter_columns(
        arr.ctypes.data_as(ctypes.c_void_p), I, L, arr.itemsize,
        keep_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return arr[:, :nkeep]


def hash128_native(arr: np.ndarray) -> Optional[bytes]:
    """16-byte content digest of a C-contiguous array (OpenMP chunked
    mixing, ~memory-bandwidth speed), or None when the lib is absent."""
    lib = _load()
    if lib is None or not arr.flags.c_contiguous:
        return None
    out = (ctypes.c_uint64 * 2)()
    lib.gt_hash128(arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes, out)
    return bytes(out)


def read_freq_native(path: str, names_raw: bytes, alleles: np.ndarray,
                     nloci: int) -> "np.ndarray | None":
    """Happy-path freq-file parse (5-column validation, locus-name match,
    allele flip); None on any anomaly or missing lib — the caller falls
    back to the Python reader, whose error text matches the reference."""
    lib = _load()
    if lib is None:
        return None
    al = np.ascontiguousarray(alleles.astype("S1"))
    out = np.empty(nloci, dtype=np.float64)
    rc = lib.gt_read_freq(
        path.encode(), names_raw, len(names_raw),
        al.ctypes.data_as(ctypes.c_char_p), nloci,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out if rc == 0 else None


def write_freq_chrom_native(path: str, append: bool, chrom: str,
                            names: List[str], positions: np.ndarray,
                            alleles: np.ndarray, freq: np.ndarray) -> bool:
    """Append one chromosome to the gz freq file; False -> caller falls back
    to the Python writer."""
    lib = _load()
    if lib is None:
        return False
    names_raw = names.raw if hasattr(names, "raw") else \
        "\n".join(names).encode()
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    al = np.ascontiguousarray(alleles.astype("S1"))
    fr = np.ascontiguousarray(freq, dtype=np.float64)
    rc = lib.gt_write_freq_chrom(
        path.encode(), 1 if append else 0, chrom.encode(), names_raw,
        len(names_raw),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        al.ctypes.data_as(ctypes.c_char_p),
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pos.shape[0])
    if rc != 0:
        raise IOError(f"native freq write failed for {path}")
    return True


def assemble_runs_native(covered_packed: np.ndarray, br: np.ndarray,
                         positions: np.ndarray, gpos: np.ndarray,
                         threshold: float, cm: bool):
    """ROH runs for one chromosome from bit-packed coverage.

    Returns (ind[int32], start[i64], stop[i64], size[f64]) in individual-major
    order, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    cp = np.ascontiguousarray(covered_packed, dtype=np.uint8)
    I, row_bytes = cp.shape
    brr = np.ascontiguousarray(br, dtype=np.uint8)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    gp = np.ascontiguousarray(gpos, dtype=np.float64)
    L = pos.shape[0]
    cap = max(1024, I * 64)
    while True:
        out_ind = np.empty(cap, dtype=np.int32)
        out_start = np.empty(cap, dtype=np.int64)
        out_stop = np.empty(cap, dtype=np.int64)
        out_size = np.empty(cap, dtype=np.float64)
        n = lib.gt_assemble_runs(
            cp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), row_bytes,
            brr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            gp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            I, L, float(threshold), 1 if cm else 0,
            out_ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_stop.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_size.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
        if n < 0:
            cap = -n
            continue
        return (out_ind[:n], out_start[:n], out_stop[:n], out_size[:n])


def lod_windows_exact_tbl_native(geno: np.ndarray, table: np.ndarray,
                                 missing: np.ndarray,
                                 winsize: int) -> Optional[np.ndarray]:
    """Exact f64 rolling LOD straight from genotypes + a [4, L] per-locus
    table (row 3 = missing = 0); skips materializing the [I, L] terms
    matrix.  None if the native lib is unavailable."""
    from ..core.types import MISSING
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(geno, dtype=np.int8)
    t = np.ascontiguousarray(table, dtype=np.float64)
    I, L = g.shape
    assert t.shape == (4, L)
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    win = np.empty((I, L), dtype=np.float64)
    lib.gt_lod_windows_exact_tbl(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, float(MISSING),
        win.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return win

def lod_windows_exact_thin_native(geno: np.ndarray, table: np.ndarray,
                                  missing: np.ndarray, winsize: int,
                                  step: int) -> "Optional[np.ndarray]":
    """Thinned exact f64 rolling LOD: the identical rolling recurrence as
    lod_windows_exact_tbl_native, writing only columns 0, step, 2*step...
    -> [I, ceil(L/step)] (== win[:, ::step]); the full [I, L] matrix
    never exists.  None if the native lib is unavailable."""
    from ..core.types import MISSING
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(geno, dtype=np.int8)
    t = np.ascontiguousarray(table, dtype=np.float64)
    I, L = g.shape
    assert t.shape == (4, L)
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    nthin = -(-L // step)
    out = np.empty((I, nthin), dtype=np.float64)
    lib.gt_lod_windows_exact_thin(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, step, float(MISSING),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out



def lod_windows_exact_native(terms: np.ndarray, missing: np.ndarray,
                             winsize: int) -> np.ndarray:
    from ..core.types import MISSING
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    terms = np.ascontiguousarray(terms, dtype=np.float64)
    I, L = terms.shape
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    win = np.empty((I, L), dtype=np.float64)
    lib.gt_lod_windows_exact(
        terms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, float(MISSING),
        win.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return win
