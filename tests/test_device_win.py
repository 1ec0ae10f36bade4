"""DeviceWin layout tests: the bucketed padded [I2, NW2] representation
must be indistinguishable from the plain [I, L] layout through every
accessor (to_numpy, thinned samples, coverage masks, assembly)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from garlic_tpu.core.types import MISSING
from garlic_tpu.ops import assembly
from garlic_tpu.ops.device_win import (DeviceWin, covered_mask,
                                       thinned_block)


def _pair(I=9, L=333, W=12, I2=32, NW2=512, seed=0):
    """Build equivalent plain and padded DeviceWins from random scores."""
    rng = np.random.default_rng(seed)
    nwin = L - W + 1
    scores = rng.normal(size=(I, nwin)).astype(np.float32)
    miss = rng.random(nwin) < 0.1
    scores[:, miss] = MISSING

    plain = np.full((I, L), np.float32(MISSING), dtype=np.float32)
    plain[:, :nwin] = scores
    padded = np.full((I2, NW2), np.float32(MISSING), dtype=np.float32)
    padded[:I, :nwin] = scores
    # bucket padding rows hold garbage that accessors must never leak
    padded[I:, :] = 123.0
    a = DeviceWin(win=jnp.asarray(plain), nind=I, nloci=L)
    b = DeviceWin(win=jnp.asarray(padded), nind=I, nloci=L, nwin=nwin)
    return a, b


def test_to_numpy_equivalent():
    a, b = _pair()
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


def test_thinned_equivalent_sample_sets():
    a, b = _pair(seed=3)
    for step in (1, 7, 12):
        ta = thinned_block(a, step)
        tb = thinned_block(b, step)
        # identical non-MISSING sample multisets (slot layouts may differ
        # past nwin, but those slots are all MISSING)
        va = np.sort(ta[ta != MISSING])
        vb = np.sort(tb[tb != MISSING])
        np.testing.assert_array_equal(va, vb)


def test_covered_mask_equivalent():
    a, b = _pair(seed=5, W=12)
    ca = covered_mask(a, 0.5, 12, 3.0)
    cb = covered_mask(b, 0.5, 12, 3.0)
    np.testing.assert_array_equal(ca[: a.nind], cb[: b.nind])
    assert ca.shape[1] == a.nloci and cb.shape[1] == b.nloci


class _Centro:
    def start(self, c):
        return 10**9

    def end(self, c):
        return 10**9 + 1


class _Chrom:
    def __init__(self, L, seed):
        rng = np.random.default_rng(seed)
        self.chrom = "chr1"
        self.positions = np.cumsum(
            rng.integers(200, 3000, L)).astype(np.int64)
        self.gpos = np.zeros(L)


def test_assembly_equivalent():
    I, L, W = 9, 333, 12
    a, b = _pair(I=I, L=L, W=W, seed=7)
    chrom = _Chrom(L, 7)
    ids = [f"I{i}" for i in range(I)]
    ra, la = assembly.assemble_roh([a], [chrom], ids, _Centro(), 0.4, W,
                                   200000, 0.25, False)
    rb, lb = assembly.assemble_roh([b], [chrom], ids, _Centro(), 0.4, W,
                                   200000, 0.25, False)
    np.testing.assert_array_equal(la, lb)
    for x, y in zip(ra, rb):
        assert [(c.start, c.stop, c.size) for c in x.calls] == \
               [(c.start, c.stop, c.size) for c in y.calls]


def test_tie_patrol_flags_and_repair():
    """covered_dispatch(tie_delta) flags exactly the rows holding a
    window inside the band, and assemble-side repair replaces those
    rows' coverage bits with the exact_cover result."""
    import jax.numpy as jnp
    from garlic_tpu.ops.device_win import DeviceWin, covered_packed

    I, N, W = 6, 400, 10
    cutoff = 1.0
    win = np.full((I, N), -5.0, np.float32)
    win[1, 100] = cutoff + 5e-4        # inside a 1e-3 band
    win[2, 200] = cutoff + 0.5         # far above: covered, not suspect
    win[3, 300] = cutoff - 5e-4        # inside the band from below
    dw = DeviceWin(win=jnp.asarray(win), nind=I, nloci=N)
    packed, sus, susw = covered_packed(dw, cutoff, W, 1.0,
                                       tie_delta=1e-3)
    np.testing.assert_array_equal(sus[:I], [False, True, False, True,
                                            False, False])
    # window detail: exact flat positions + the f32 side of each
    assert susw is not None
    si, sw, sside = susw
    assert set(zip(si.tolist(), sw.tolist(), sside.tolist())) == \
        {(1, 100, True), (3, 300, False)}
    # without a band nothing is flagged
    _, sus0, _ = covered_packed(dw, cutoff, W, 1.0)
    assert not sus0[:I].any()

    # repair path: exact_cover says row 1's window was NOT above (the f64
    # truth for a window sitting 5e-4 above the f32 cutoff could go
    # either way; here we force 'below') -> its run disappears
    from garlic_tpu.ops import assembly

    class _C:
        nind = I
        nloci = N
        positions = np.arange(1, N + 1, dtype=np.int64) * 1000
        gpos = np.zeros(N)
        chrom = "chr1"

    def exact_cover(ci, rows):
        assert ci == 0 and list(rows) == [1, 3]
        return np.zeros((len(rows), N), dtype=bool)

    class _Centro:
        def start(self, c):
            return 0

        def end(self, c):
            return 0

    runs = assembly._chrom_runs_native(
        dw, _C(), cutoff, W, 10**9, 0, 0, 1.0, False,
        handle=None, tie_delta=1e-3, exact_cover=exact_cover, ci=0)
    if runs is not None:  # native lib present
        ind_arr = runs[0]
        assert 1 not in ind_arr and 3 not in ind_arr  # repaired away
        assert 2 in ind_arr                           # untouched row kept


def test_tie_patrol_window_cap_overflow_degrades_to_rows():
    """> _SUS_IDX_CAP suspect windows: the window detail comes back None
    and the repair degrades to row-level exact recomputation of every
    flagged row (correct, just slower)."""
    import jax.numpy as jnp
    from garlic_tpu.ops import device_win as dwm
    from garlic_tpu.ops.device_win import DeviceWin, covered_packed

    I, N, W = 8, 2048, 10
    cutoff = 1.0
    win = np.full((I, N), cutoff + 1e-5, np.float32)  # everything in-band
    dw = DeviceWin(win=jnp.asarray(win), nind=I, nloci=N)
    packed, sus, susw = covered_packed(dw, cutoff, W, 1.0, tie_delta=1e-3)
    assert sus[:I].all()
    assert susw is None  # I * N = 16384 > _SUS_IDX_CAP
    assert I * N > dwm._SUS_IDX_CAP


def test_tie_patrol_block_cap_overflow_degrades_to_rows():
    """> _SUS_BLK_CAP nonempty suspect blocks with nsusw <= _SUS_IDX_CAP:
    the block gather drops blocks past the cap, so the window detail MUST
    come back None (row-level repair) — returning a detail list with -1
    fills inside it would silently skip the dropped blocks' suspects and
    verify a bogus (row -1, col N-1) window (round-3 advisor finding)."""
    import jax.numpy as jnp
    from garlic_tpu.ops import device_win as dwm
    from garlic_tpu.ops.device_win import DeviceWin, covered_packed

    I, N, W = 34, 16384, 10
    cutoff = 1.0
    blk = dwm._EDGE_BLOCK
    nsblk = I * (N // blk)
    assert nsblk > dwm._SUS_BLK_CAP and nsblk <= dwm._SUS_IDX_CAP
    win = np.full((I, N), -5.0, np.float32)
    win[:, ::blk] = cutoff + 1e-5  # one suspect per 128-window block
    dw = DeviceWin(win=jnp.asarray(win), nind=I, nloci=N)
    packed, sus, susw = covered_packed(dw, cutoff, W, 1.0, tie_delta=1e-3)
    assert sus[:I].all()
    assert susw is None  # block cap overflow -> row-level repair
