"""TGLS genotype-likelihood loading.

Reproduces readTGLSData (src/garlic-data.cpp:1516-1586): rows align 1:1 with
TPED rows (4 leading junk columns then one value per individual); values are
converted by --gl-type:

  GQ: phred-scaled likelihood the genotype is WRONG  -> p_err = 10^(GQ/-10)
  PL: phred-scaled likelihood the genotype is right  -> p_err = 1 - 10^(PL/-10)
  GL: log10 likelihood the genotype is right         -> p_err = 1 - 10^GL

Exponents are clamped at -10 and results to (1e-16, 1]
(src/garlic-data.cpp:1557-1576).
"""

from __future__ import annotations

import gzip
from typing import List

import numpy as np

from ..core.types import ChromData, GarlicDataError


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


class TglsError(GarlicDataError):
    pass


def convert_gl(vals: np.ndarray, gl_type: str) -> np.ndarray:
    """Vectorized GL conversion, matching the scalar reference ops exactly.

    Overflow (a huge positive GL token -> 10**x = inf -> 1-inf = -inf) is
    intentional and matches the reference's C pow(): the <= 0 clamp below
    turns it into 1e-16 either way, so numpy's warning is suppressed."""
    v = vals.astype(np.float64)
    with np.errstate(over="ignore"):
        if gl_type == "GQ":
            e = v / -10.0
            e = np.maximum(e, -10.0)
            out = 10.0 ** e
        elif gl_type == "GL":
            e = np.maximum(v, -10.0)
            out = 1.0 - 10.0 ** e
        elif gl_type == "PL":
            e = v / -10.0
            e = np.maximum(e, -10.0)
            out = 1.0 - 10.0 ** e
        else:
            raise TglsError(f"unknown GL type {gl_type}")
        out = np.where(out <= 0, 1e-16, out)
        out = np.where(out > 1, 1.0, out)
    return out


def _bad_shape(log, got: int, expected_ind: int):
    if log is not None:
        log.err("ERROR: Incorrect number of columns in tgls file: ",
                got, nl=False)
        log.err(". Expected: ", expected_ind)
    raise TglsError("bad tgls shape")


def read_tgls(filename: str, chroms: List[ChromData], expected_ind: int,
              gl_type: str, log=None, panel_cache: bool = False,
              col_range=None) -> None:
    """Attach per-genotype error data [I, L] to each ChromData in place.

    Prefers the native reader (chunked gz + parallel tokenize): GQ/PL-
    style files with <= 255 distinct tokens come back as a u8 code
    matrix + converted-value lut (`gl_codes`/`gl_lut`) — 8x smaller than
    the double matrix — with the f64 `gl` matrix materializing lazily for consumers that need it.  Falls back
    to the pure-Python line reader when the native library is absent.

    With panel_cache=True (--tpu-panel-cache) the parse result also
    round-trips through a `<tgls>.gtlc` sidecar holding the RAW values
    (pre --gl-type conversion, so one sidecar serves any type): warm
    runs mmap it instead of re-inflating and re-tokenizing the file.

    col_range=(c0, c1): per-host sharded input — only that individual
    row slice attaches to the chromosomes (which hold the same local
    rows).  Warm .gtlc loads stay zero-copy row views (host RAM scales
    1/num_hosts); a cold parse still tokenizes the full file (each
    host must scan every line anyway) and slices afterward, so only
    its steady-state memory shrinks."""
    from ..native import parse_tgls_native
    row_counts = [c.nloci for c in chroms]
    r = None
    if panel_cache:
        from .panelcache import load_tgls_cache
        r = load_tgls_cache(filename, expected_ind, row_counts)
    fresh = r is None
    if r is None:
        try:
            r = parse_tgls_native(filename, expected_ind, row_counts)
        except Exception:
            r = None
    if r is None:
        _read_tgls_python(filename, chroms, expected_ind, gl_type, log)
        if col_range is not None:
            c0 = max(min(int(col_range[0]), expected_ind), 0)
            c1 = max(min(int(col_range[1]), expected_ind), c0)
            for c in chroms:
                if c._gl is not None:
                    c._gl = c._gl[c0:c1]
        return
    if "bad_cols" in r:
        _bad_shape(log, int(r["bad_cols"]), expected_ind)
    if panel_cache and fresh:
        # save the FULL matrices before any row slicing: the sidecar is
        # a whole-panel artifact shared by every host/run shape
        from .panelcache import save_tgls_cache
        save_tgls_cache(filename, expected_ind, row_counts, r["mode"],
                        r.get("lut"), r["chroms"])
    if col_range is not None:
        c0 = max(min(int(col_range[0]), expected_ind), 0)
        c1 = max(min(int(col_range[1]), expected_ind), c0)
        r = dict(r)
        r["chroms"] = [m[c0:c1] for m in r["chroms"]]
    if r["mode"] == "codes":
        # equal tokens parse to equal doubles, so converting the lut is
        # bit-identical to converting every matrix element
        lut = convert_gl(r["lut"], gl_type)
        for c, codes in zip(chroms, r["chroms"]):
            c.gl_codes = codes
            c.gl_lut = lut
    else:
        for c, vals in zip(chroms, r["chroms"]):
            c.gl = convert_gl(vals, gl_type)


def _read_tgls_python(filename: str, chroms: List[ChromData],
                      expected_ind: int, gl_type: str, log=None) -> None:
    with _open_maybe_gz(filename) as fin:
        for c in chroms:
            rows = np.empty((c.nloci, expected_ind), dtype=np.float64)
            for locus in range(c.nloci):
                line = fin.readline()
                fields = line.split()
                if len(fields) != expected_ind + 4:
                    _bad_shape(log, len(fields), expected_ind)
                rows[locus] = np.asarray(fields[4:], dtype=np.float64)
            c.gl = convert_gl(rows, gl_type).T.copy()  # [I, L]
