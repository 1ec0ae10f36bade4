"""Checks that need an NVIDIA GPU (marker `gpu`).  Whether a GPU is
present is decided inside the fixture, never at import, so every worker
collects the same tests; elsewhere they skip.  Run them on a GPU host with
`JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu`;
chip_smoke.py runs the same checks at WGS size."""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture
def on_gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_device_phase1_within_tie_band(on_gpu):
    """The bucketed XLA Phase-I program, compiled for the card, stays
    inside a quarter of the tie patrol's band around the f64 windows."""
    from garlic_tpu.centromeres import Centromere
    from garlic_tpu.core.types import MISSING, ChromData
    from garlic_tpu.logger import RunLog
    from garlic_tpu.ops import device_win, lod
    from garlic_tpu.pipeline import _corner_tmax

    rng = np.random.default_rng(0)
    I, L = 64, 20000
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    freq = np.clip(rng.beta(0.8, 0.8, L), 0.02, 0.98)
    pos = np.cumsum(rng.integers(100, 8000, L)).astype(np.int64)
    c = ChromData(chrom="chr1", positions=pos, gpos=np.zeros(L),
                  locus_names=[f"rs{i}" for i in range(L)],
                  alleles=np.array(["A"] * L), genotypes=geno, freq=freq)
    centro = Centromere("hg18", "none", "none", RunLog())
    for W in (60, 300):
        fast = device_win.lod_windows_device(c, centro, W, 0.001, 200000,
                                             False).to_numpy()
        exact = lod.calc_lod_windows(c, centro, W, 0.001, 200000, False,
                                     engine="exact")
        live = exact != MISSING
        err = np.max(np.abs(fast[live] - exact[live]))
        assert err <= 64 * 2.0 ** -23 * W * _corner_tmax(c, 0.001, False)
