"""Native (C++) host kernels: streaming gzip TPED parsing and the exact
float64 rolling-LOD recurrence.

Built on demand with g++ into a shared library loaded via ctypes.  Import
errors fall back to the pure-Python implementations transparently.
"""

from .build import (  # noqa: F401
    assemble_runs_native,
    covered_pack_native,
    filter_columns_native,
    filter_pack_2bit_native,
    gsl_sd_native,
    hash128_native,
    get_native_max_threads,
    lod_windows_exact_native,
    lod_windows_exact_tbl_native,
    lod_windows_exact_thin_native,
    native_available,
    parse_tgls_native,
    parse_tped_native,
    repad_2bit_native,
    set_native_threads,
    unpack_2bit_native,
    read_freq_native,
    write_freq_chrom_native,
)
