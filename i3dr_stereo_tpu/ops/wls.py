"""Edge-aware weighted-least-squares disparity filtering / hole filling.

The reference's "interp" path runs cv::ximgproc's WLS disparity filter
(lambda=8000, sigma=1.5) over forward+backward matches
(matcherOpenCVBlock.cpp:22-33, matcherOpenCVSGBM.cpp:22-33); the Phobos
engine instead offers a 32-direction Gauss interpolator for gaps
(ini/quick.param "Interpolator Mode = Gauss").

Implementation: the Fast Global Smoother formulation of WLS
(separable 1D global smoothing, alternating horizontal/vertical passes).
Each 1D pass solves a tridiagonal system

    (a_i + lam (w_{i-1} + w_i)) u_i - lam w_{i-1} u_{i-1} - lam w_i u_{i+1}
        = a_i d_i

with guide-image edge weights w_i = exp(-|I_{i+1} - I_i| / sigma) and
data weight a_i = 1 on valid pixels, 0 in holes — so holes are filled by
edge-respecting diffusion while valid pixels stay anchored. The Thomas
solver's two sweeps are `lax.scan`s along the pass axis, vectorized over
the perpendicular axis (same wavefront shape as the SGM reference's
scans).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _thomas_rows(a: jax.Array, w: jax.Array, d: jax.Array, lam: float) -> jax.Array:
    """Solve the 1D WLS system along the last axis.

    a: (..., N) data weights; w: (..., N-1) edge weights between i,i+1;
    d: (..., N) data. Returns u (..., N).
    """
    N = d.shape[-1]
    zeros = jnp.zeros_like(d[..., :1])
    wl = jnp.concatenate([zeros, w], axis=-1)          # w_{i-1}, 0 at i=0
    wr = jnp.concatenate([w, zeros], axis=-1)          # w_i, 0 at i=N-1
    diag = a + lam * (wl + wr) + 1e-8
    lower = -lam * wl                                   # coefficient of u_{i-1}
    upper = -lam * wr                                   # coefficient of u_{i+1}
    rhs = a * d

    # forward elimination (scan over last axis)
    def fwd(carry, x):
        cp_prev, dp_prev = carry
        lo, di, up, r = x
        denom = di - lo * cp_prev
        cp = up / denom
        dp = (r - lo * dp_prev) / denom
        return (cp, dp), (cp, dp)

    xs = (jnp.moveaxis(lower, -1, 0), jnp.moveaxis(diag, -1, 0),
          jnp.moveaxis(upper, -1, 0), jnp.moveaxis(rhs, -1, 0))
    init = (jnp.zeros_like(d[..., 0]), jnp.zeros_like(d[..., 0]))
    _, (cps, dps) = jax.lax.scan(fwd, init, xs)

    # back substitution
    def bwd(u_next, x):
        cp, dp = x
        u = dp - cp * u_next
        return u, u

    _, us = jax.lax.scan(bwd, jnp.zeros_like(d[..., 0]), (cps, dps), reverse=True)
    return jnp.moveaxis(us, 0, -1)


def _edge_weights(guide: jax.Array, sigma: float, axis: int) -> jax.Array:
    diff = jnp.abs(jnp.diff(guide, axis=axis))
    return jnp.exp(-diff / max(sigma, 1e-6))


@partial(jax.jit, static_argnames=("lam", "sigma_color", "iters"))
def wls_filter(disp: jax.Array, conf: jax.Array, guide: jax.Array,
               lam: float = 8000.0, sigma_color: float = 1.5,
               iters: int = 3) -> jax.Array:
    """Confidence-weighted WLS smoothing of disparity guided by the left
    image. conf in [0,1]; guide in [0,255] (sigma is in intensity units
    scaled to [0,1] like ximgproc, so guide is normalized internally)."""
    g = guide.astype(jnp.float32) / 255.0
    sigma = sigma_color / 10.0  # ximgproc sigma 1.5 operates on ~[0,25] luma diffs
    d = jnp.where(conf > 0, disp, 0.0)
    a = conf.astype(jnp.float32)

    wh = _edge_weights(g, sigma, axis=-1)
    wv = _edge_weights(g, sigma, axis=-2)

    u = d
    T = iters
    for t in range(1, T + 1):
        # FGS per-iteration lambda schedule: lam_t = 1.5 lam 4^(T-t) / (4^T - 1)
        lam_t = 1.5 * lam * (4.0 ** (T - t)) / (4.0 ** T - 1.0)
        # horizontal pass
        u = _thomas_rows(a, wh, u, lam_t)
        # vertical pass: transpose H<->W
        ut = jnp.swapaxes(u, -1, -2)
        at = jnp.swapaxes(a, -1, -2)
        wvt = jnp.swapaxes(wv, -1, -2)
        ut = _thomas_rows(at, wvt, ut, lam_t)
        u = jnp.swapaxes(ut, -1, -2)
        # after the first sweep every pixel has support; anchor holes softly
        a = jnp.maximum(a, 0.1)
    return u


@jax.jit
def wls_fill(disp: jax.Array, valid: jax.Array, guide: jax.Array
             ) -> tuple[jax.Array, jax.Array]:
    """The reference's "interp" behavior: smooth + fill holes, then mark
    everything valid ("will smooth holes but give less accurate results",
    cfg/i3DR_Disparity.cfg:38)."""
    filled = wls_filter(disp, valid.astype(jnp.float32), guide)
    out = jnp.where(valid, disp, filled)
    return out, jnp.ones_like(valid)


@partial(jax.jit, static_argnames=("lrc_thresh",))
def lr_confidence(disp: jax.Array, valid: jax.Array, disp_right: jax.Array,
                  valid_right: jax.Array, lrc_thresh: float = 1.5
                  ) -> jax.Array:
    """Left-right consistency confidence in [0, 1].

    The reference's interp path feeds a forward AND a backward match into
    cv::ximgproc's WLS filter, whose confidence is LRC-driven: full
    confidence where |d_L(x) - d_R(x - d_L(x))| is small, decaying to 0
    past the threshold (matcherOpenCVBlock.cpp:22-33 wires
    setLRCthresh-controlled filtering; DisparityWLSFilter
    computeConfidenceMap). disp_right is the right-anchored disparity
    with the same (positive) sign convention as
    :meth:`~i3dr_stereo_tpu.matchers.base.StereoMatcher.backward_match`.
    """
    B, H, W = disp.shape if disp.ndim == 3 else (1,) + disp.shape
    d3 = disp if disp.ndim == 3 else disp[None]
    v3 = valid if valid.ndim == 3 else valid[None]
    dr3 = disp_right if disp_right.ndim == 3 else disp_right[None]
    vr3 = valid_right if valid_right.ndim == 3 else valid_right[None]
    d_int = jnp.round(d3).astype(jnp.int32)
    xr = jnp.arange(W, dtype=jnp.int32)[None, None, :] - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = jnp.clip(xr, 0, W - 1)
    r_at = jnp.take_along_axis(dr3, xr_c, axis=2)
    r_ok = jnp.take_along_axis(vr3, xr_c, axis=2)
    err = jnp.abs(d3 - r_at)
    # ramp: 1 inside the threshold, linear decay to 0 by 2x threshold
    ramp = jnp.clip(2.0 - err / jnp.maximum(lrc_thresh, 1e-6), 0.0, 1.0)
    conf = jnp.where(v3 & in_img & r_ok, ramp, 0.0)
    return conf if disp.ndim == 3 else conf[0]


def wls_fill_lr(disp: jax.Array, valid: jax.Array, disp_right: jax.Array,
                valid_right: jax.Array, guide: jax.Array,
                lam: float = 8000.0, sigma_color: float = 1.5,
                lrc_thresh: float = 1.5) -> tuple[jax.Array, jax.Array]:
    """Backward-match-driven WLS interpolation — the reference's full
    interp path (matcherOpenCVBlock.cpp:22-33, matcherOpenCVSGBM.cpp:
    22-33: forwardMatch + backwardMatch -> DisparityWLSFilter with
    lambda=8000, sigma=1.5). Low-LR-confidence pixels are re-estimated by
    edge-aware diffusion from confident neighbours; holes fill the same
    way; everything is returned valid."""
    conf = lr_confidence(disp, valid, disp_right, valid_right, lrc_thresh)
    filtered = wls_filter(disp, conf, guide, lam=lam,
                          sigma_color=sigma_color)
    out = jnp.where(conf >= 1.0, disp, filtered)
    return out, jnp.ones_like(valid)
