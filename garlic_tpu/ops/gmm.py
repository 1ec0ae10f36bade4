"""Phase IV: 1-D Gaussian mixture model fit with EM.

Port of GMM (src/gmm.cpp:160-443) and its driver selectSizeClasses
(src/garlic-roh.cpp:935-1003): K components (default 3), log-space
responsibilities with logsumexp, fused E+M pass, convergence when
|delta loglikelihood| <= 1e-5, max 1000 iterations.  Initialization spreads
means/variances from the data mean/variance:

    W_k = 1/K,  Mu_k = mean*(k+1)/(K+1),  Sigma_k = var*(k+1)/K

A distributed variant exposes the per-iteration sufficient statistics
(sum_w, sum_wx, sum_wx2, loglik) so they can be psum-ed across a device mesh
(see gmm_em_sharded in garlic_tpu/parallel/engine.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

_LOG2PI_C = -0.5 * np.log(2.0 * np.pi)


@dataclass
class GMMResult:
    weights: np.ndarray   # [K] mixture coefficients
    means: np.ndarray     # [K]
    variances: np.ndarray  # [K]
    loglikelihood: float
    bic: float
    converged: bool
    iterations: int


def gmm_sufficient_stats(x: np.ndarray, w: np.ndarray, mu: np.ndarray,
                         var: np.ndarray):
    """One E-step over data x -> (sum_wj, sum_wj_xj, sum_wj_xj2, loglik).

    Matches GMM::update's math (src/gmm.cpp:276-331): log responsibilities
    log(a_k) + normalLog, logsumexp per point, an extra normalization by the
    (==1) sum of responsibilities, then weighted moment sums."""
    with np.errstate(divide="ignore", invalid="ignore"):
        lw = np.log(w)[None, :]                              # [1,K]
        lv = np.log(var)[None, :]
        d = x[:, None] - mu[None, :]                         # [N,K]
        logp = lw + (_LOG2PI_C - 0.5 * lv - (d * d) / (2.0 * var[None, :]))
    lmax = np.max(logp, axis=1, keepdims=True)
    tmp = lmax[:, 0] + np.log(np.sum(np.exp(logp - lmax), axis=1))
    loglik = float(np.sum(tmp))
    resp = np.exp(logp - tmp[:, None])                       # [N,K]
    den = np.sum(resp, axis=1, keepdims=True)
    r = resp / den
    sum_wj = r.sum(axis=0)
    sum_wj_xj = (x[:, None] * r).sum(axis=0)
    sum_wj_xj2 = ((x * x)[:, None] * r).sum(axis=0)
    return sum_wj, sum_wj_xj, sum_wj_xj2, loglik


def fit_gmm(x: np.ndarray, k: int, w0: np.ndarray, mu0: np.ndarray,
            var0: np.ndarray, max_iter: int = 1000, precision: float = 1e-5,
            verbose: bool = False) -> GMMResult:
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    w, mu, var = w0.copy(), mu0.copy(), var0.copy()
    last_ll = -np.finfo(np.float64).max
    ll = last_ll
    bic = np.finfo(np.float64).max
    converged = False
    if verbose:
        print(f"Begin GMM estimation with k = {k} Gaussians...", file=sys.stderr)
    it = 0
    for it in range(1, max_iter + 1):
        s_w, s_wx, s_wx2, ll = gmm_sufficient_stats(x, w, mu, var)
        with np.errstate(divide="ignore", invalid="ignore"):
            w = s_w / float(n)
            mu = s_wx / s_w
            var = s_wx2 / s_w - mu * mu
        if not np.all(np.isfinite(mu)) or not np.all(np.isfinite(var)):
            raise FloatingPointError(
                "GMM component collapsed (non-finite parameters)")
        bic = -2.0 * ll + (3.0 * k - 1) * np.log(n)
        if abs(ll - last_ll) <= precision:
            converged = True
            break
        last_ll = ll
    return GMMResult(weights=w, means=mu, variances=var, loglikelihood=ll,
                     bic=float(bic), converged=converged, iterations=it)


def _g_format_stable(res: "GMMResult", rel: float = 3e-12) -> bool:
    """True when every logged GMM parameter formats to the same %g string
    under a +-rel relative perturbation — i.e. no parameter sits within
    the calibrated device-vs-host EM deviation (~1e-13 relative, margin
    here 3e-12) of a %g rounding boundary, so the device fit's .log lines
    are guaranteed byte-identical to the host fit's."""
    from ..core.fmt import g
    for arr in (res.weights, res.means, res.variances):
        for v in arr:
            v = float(v)
            d = abs(v) * rel
            if g(v + d) != g(v) or g(v - d) != g(v):
                return False
    return True


_single_gmm_mesh = None


def _device_mesh_1x1():
    """Cached trivial ("dp", "sp") mesh over device 0: lets single-device
    fast-engine runs reuse fit_gmm_sharded's on-device while_loop EM (the
    psums over the size-1 axes are identity).  The host EM iterates
    numpy at ~1-2 ms per E+M pass — ~1.8 s of the 1000x1M
    auto-everything wall (BASELINE.md round 3); the device loop runs
    every iteration in one dispatch."""
    global _single_gmm_mesh
    if _single_gmm_mesh is None:
        from ..parallel.mesh import make_mesh
        import jax
        _single_gmm_mesh = make_mesh(n_dp=1, n_sp=1,
                                     devices=jax.devices()[:1])
    return _single_gmm_mesh


def select_size_classes(lengths: np.ndarray, nclust: int, log=None,
                        mesh=None, device=False):
    """selectSizeClasses (src/garlic-roh.cpp:935-1003): fit the GMM, sort
    components by mean, log their parameters, then root-find the K-1 pairwise
    Gaussian intersections as size-class boundaries. Returns list of bounds.

    mesh: a ("dp", "sp") jax mesh — the EM loop runs on device with the
    sufficient statistics psum'd across every chip per iteration
    (parallel.engine.fit_gmm_sharded), the production Phase-IV path for
    --tpu-mesh runs.  device=True (fast engine, no mesh): the same
    on-device EM over a trivial 1x1 mesh."""
    from .brent import find_boundary
    lengths = np.asarray(lengths, dtype=np.float64)
    var = float(np.var(lengths, ddof=1))
    mean = float(np.mean(lengths))
    k = nclust
    w0 = np.full(k, 1.0 / k)
    mu0 = np.array([mean * (n + 1) / (k + 1) for n in range(k)])
    var0 = np.array([var * (n + 1) / k for n in range(k)])
    # Size-gated: the device EM's jnp reductions agree with the host
    # EM's numpy pairwise sums only to ~1e-13 relative, and the exact
    # engine always uses the host EM — below the gate the fast engine
    # keeps the bit-identical host path (test/fuzz panels produce at
    # most a few hundred ROH), above it the ulp-class trade buys back
    # ~1.6 s at 28k ROH and ~0.25 s at the 22-chrom WGS flagship's 5.4k
    # (BASELINE.md).
    auto_1x1 = False
    if mesh is None and device and lengths.shape[0] >= 4096:
        mesh = _device_mesh_1x1()
        auto_1x1 = True
    if mesh is not None:
        from ..parallel.engine import fit_gmm_sharded
        res = fit_gmm_sharded(lengths, k, w0, mu0, var0, mesh,
                              max_iter=1000, precision=1e-5, verbose=True)
        if auto_1x1 and not _g_format_stable(res):
            # %g boundary guard: the device EM agrees with the host EM
            # only to ~1e-13 relative, invisible at %g's 6 significant
            # digits UNLESS a parameter lands within that band of a %g
            # rounding boundary — and the GMM lines are a compared .log
            # artifact.  The stability check (format each logged value
            # perturbed +-3e-12 relative) costs microseconds; only a
            # boundary-straddling fit pays the bit-exact host EM rerun,
            # making .log byte-invariance unconditional.
            res = fit_gmm(lengths, k, w0, mu0, var0, max_iter=1000,
                          precision=1e-5, verbose=False)
    else:
        res = fit_gmm(lengths, k, w0, mu0, var0, max_iter=1000,
                      precision=1e-5, verbose=True)
    order = np.argsort(res.means, kind="stable")
    size_class = "A"
    for i in range(k):
        j = order[i]
        if log is not None:
            log.log("Gaussian class", size_class, nl=False)
            log.log(" ( mixture, mean, std ) = (", float(res.weights[j]), nl=False)
            log.log(",", float(res.means[j]), nl=False)
            log.log(",", float(res.variances[j]), nl=False)
            log.log(" )")
        size_class = chr(ord(size_class) + 1)
    bounds = []
    for i in range(1, k):
        a, b = order[i - 1], order[i]
        bounds.append(find_boundary(
            res.means[a], res.variances[a], res.weights[a],
            res.means[b], res.variances[b], res.weights[b],
            max_iter=1000, epsabs=1e-4))
    return bounds, res
