"""CLI flag-registry tests: parsing semantics (param_t port), validator
matrix, and oracle agreement on rejection behavior."""

from __future__ import annotations

import numpy as np
import pytest

from garlic_tpu import cli
from garlic_tpu.logger import RunLog


def parse(*argv):
    return cli.parse_command_line(list(argv))


def test_defaults():
    a = parse()
    assert a[cli.ARG_WINSIZE] == 0
    assert a[cli.ARG_ERROR] == pytest.approx(-1.0)
    assert a[cli.ARG_MAX_GAP] == 200000
    assert a[cli.ARG_NCLUST] == 3
    assert a[cli.ARG_KDE_SUBSAMPLE] == 20
    assert a[cli.ARG_THREADS] == 1
    assert a[cli.ARG_OUTFILE] == "outfile"
    assert a[cli.ARG_TPED_MISSING] == "0"
    assert a[cli.ARG_M] == 7
    assert a[cli.ARG_MU] == pytest.approx(1e-9)
    assert not a[cli.ARG_WEIGHTED]


def test_unknown_flag_rejected():
    with pytest.raises(cli.CLIError):
        parse("--definitely-not-a-flag")


def test_typed_parsing():
    a = parse("--winsize", "60", "--error", "0.001", "--out", "x",
              "--weighted", "--size-bounds", "1000", "2000", "3000")
    assert a[cli.ARG_WINSIZE] == 60
    assert a[cli.ARG_ERROR] == pytest.approx(0.001)
    assert a[cli.ARG_WEIGHTED] is True
    assert list(a[cli.ARG_BOUND_SIZE]) == [1000.0, 2000.0, 3000.0]


def test_scientific_notation_rejected():
    """param_t::goodDouble (src/param_t.cpp:232-245) only admits digits,
    one '.', and a leading '-' — '1e-8' is not a valid double there, and
    our parser preserves the quirk (decimal notation is required)."""
    with pytest.raises(cli.CLIError, match="1e-8 is not a valid double"):
        parse("--mu", "1e-8")
    a = parse("--mu", "0.00000001")
    assert a[cli.ARG_MU] == pytest.approx(1e-8)


def test_help_returns_none(capsys):
    assert parse("--help") is None
    assert "--winsize" in capsys.readouterr().out


def _log():
    return RunLog()


def test_validators():
    log = _log()
    # required files
    assert cli.check_required_files(log, "none", "none") is True
    assert cli.check_required_files(log, "a.tped", "none") is True
    # nclust positive
    assert cli.check_nclust(log, 0) is True
    assert cli.check_nclust(log, 3) is False
    # M >= 1, mu > 0
    assert cli.check_m(log, 0) is True
    assert cli.check_m(log, 7) is False
    assert cli.check_mu(log, 0.0) is True
    assert cli.check_mu(log, 1e-9) is False
    # build must be hg18/hg19/hg38/none
    assert cli.check_build(log, "hg17") is True
    assert cli.check_build(log, "hg38") is False
    # need at least one of build / custom centromere file
    assert cli.check_build_and_centromere_file(log, "none", "none") is True
    assert cli.check_build_and_centromere_file(log, "none", "custom.txt") is False
    assert cli.check_build_and_centromere_file(log, "hg18", "none") is False
    # threads >= 1
    assert cli.check_threads(log, 0) is True
    assert cli.check_threads(log, 2) is False
    # error in (0,1) required without TGLS
    assert cli.check_error(log, -1.0, "none") is True
    assert cli.check_error(log, 0.001, "none") is False
    # GL type required with TGLS
    assert cli.check_gl_type(log, "none", "x.tgls") is True
    assert cli.check_gl_type(log, "GQ", "x.tgls") is False
    assert cli.check_gl_type(log, "BAD", "x.tgls") is True
    # winsize > 1 unless auto modes
    assert cli.check_winsize(log, 1, False, False, False) is True
    assert cli.check_winsize(log, 10, False, False, False) is False
    # max gap positive
    assert cli.check_max_gap(log, -5) is True
    assert cli.check_max_gap(log, 200000) is False
    # overlap frac in [0, 1]
    assert cli.check_overlap_frac(log, 1.5) is True
    assert cli.check_overlap_frac(log, 0.25) is False
    # auto winsize step
    assert cli.check_auto_winsize_step(log, 0) is True
    assert cli.check_auto_winsize_step(log, 10) is False
    # cm requires map
    assert cli.check_cm(log, "none", True) is True
    assert cli.check_cm(log, "m.map", True) is False


def test_bound_sizes_sorted_and_positive():
    log = _log()
    err, auto = cli.check_bound_sizes(log, [cli.DEFAULT_BOUND_SIZE])
    assert not err and auto
    err, auto = cli.check_bound_sizes(log, [1000.0, 5000.0])
    assert not err and not auto
    err, auto = cli.check_bound_sizes(log, [5000.0, 1000.0])
    assert err  # must be strictly increasing
    err, auto = cli.check_bound_sizes(log, [-2.0, 1000.0])
    assert err  # must be positive


def test_oracle_rejects_same_flags(oracle_bin, tmp_path):
    """Spot-check: flag sets our validators reject are rejected by the
    oracle too (its .error file is non-empty / run aborts early)."""
    import subprocess
    cases = [
        ["--winsize", "1"],
        ["--error", "2.0"],
        ["--nclust", "0"],
        ["--build", "hg17"],
    ]
    for extra in cases:
        r = subprocess.run(
            [oracle_bin, "--tped", "x.tped", "--tfam", "x.tfam"] + extra +
            ["--out", str(tmp_path / "o")],
            capture_output=True, text=True, timeout=60)
        combined = (r.stdout + r.stderr).lower()
        assert "error" in combined, extra


def test_engine_auto_resolution(monkeypatch):
    """--tpu-engine auto resolves to the fast device engine when a GPU is
    attached (the tie patrol makes fast == exact BED by construction and
    Phase II pools exact f64 samples on both engines) and to exact on a
    CPU-only host; the decision is runtime.accelerator's."""
    from garlic_tpu import runtime
    from garlic_tpu.pipeline import _resolve_engine

    assert _resolve_engine("auto") == "exact"  # this host: CPU backend
    monkeypatch.setattr(runtime, "accelerator", lambda: "gpu")
    assert _resolve_engine("auto") == "fast"
    monkeypatch.setattr(runtime, "accelerator", lambda: "cpu")
    assert _resolve_engine("auto") == "exact"
    assert _resolve_engine("fast") == "fast"
    assert _resolve_engine("exact") == "exact"
