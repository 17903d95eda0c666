"""PSF-matching image subtraction on device — the hotpants replacement.

Reimplements the Alard-Lupton (1998) spatially-varying-kernel subtraction the
reference shells out to ``hotpants`` for (``zuds/hotpants.py:77-93`` builds
the command: kernel radius r=2.5*seeing, stamp half-width rss=6*seeing, 3x3
regions ``-nrx 3 -nry 3``, kernel spatial order ``-ko 4``, differential
background order ``-bgo 0``; ``zuds/subtraction.py:162`` runs it).

Method
------
The convolution kernel matching the reference PSF to the science PSF is
expanded in a Gaussian x polynomial basis (3 Gaussians of widths 0.7/1.5/3.0
x the seeing sigma with polynomial degrees 6/4/2 — the classic A&L triple),
with each coefficient varying spatially as a polynomial of order ``ko``
inside each of the 3x3 regions. The basis is sum-normalized: B_0 integrates
to 1 and every other basis function integrates to 0, so the local photometric
flux ratio is carried entirely by the B_0 coefficient field.

Fitting is linear least squares over star stamps: each stamp contributes
rows  sum_{n,m} a_nm T_m(xc,yc) (B_n * R)(p) + bg  ~  S(p), accumulated into
normal equations with inverse-variance weights and solved per region (the
whole build is batched conv + einsum). Iterative stamp rejection
(2 passes, 3-sigma in per-stamp chi2) mirrors hotpants' substamp clipping.

Design notes
------------
* Every Gaussian x monomial basis function is separable
  (B_n(u,v) = gx(u) gy(v)), so full-frame basis convolutions run as two 1-D
  convolutions each — O(K) not O(K^2) per pixel.
* The model frame accumulates over basis functions with a ``lax.scan``; peak
  memory stays at a few frames regardless of basis size.
* 3x3 region support reuses the same 49 basis convolutions — regions differ
  only in the elementwise coefficient fields blended over them.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import (KERNEL_GAUSS_DEGREES, KERNEL_GAUSS_SIGMAS,
                         KERNEL_SPATIAL_ORDER, NREG_SIDE, BIG_RMS,
                         SUB_NODATA_SENTINEL)

__all__ = ['KernelBasis', 'fit_kernel', 'apply_kernel',
           'apply_kernel_fast', 'subtract_frames']


def _einsum_hi(*args, **kwargs):
    """einsum at HIGHEST precision: a reduced-precision default (bf16
    passes, or TF32 for f32 matmuls on the GPU) is fatal to the kernel-fit
    normal equations."""
    kwargs.setdefault('precision', jax.lax.Precision.HIGHEST)
    return jnp.einsum(*args, **kwargs)


class KernelBasis:
    """Separable Gaussian x polynomial kernel basis (host-precomputed).

    ksize must be odd. ``seeing_sigma`` scales the Gaussian widths (px).
    """

    def __init__(self, ksize, seeing_sigma=2.0,
                 sigmas=KERNEL_GAUSS_SIGMAS, degrees=KERNEL_GAUSS_DEGREES):
        assert ksize % 2 == 1
        self.ksize = ksize
        r = ksize // 2
        u = np.arange(-r, r + 1, dtype=np.float64)
        gx_list, gy_list, meta = [], [], []
        for sig_f, deg in zip(sigmas, degrees):
            sig = max(sig_f * seeing_sigma, 0.5)
            g = np.exp(-u * u / (2 * sig * sig))
            for p in range(deg + 1):
                for q in range(deg + 1 - p):
                    gx_list.append(g * (u / sig) ** p)
                    gy_list.append(g * (u / sig) ** q)
                    meta.append((sig, p, q))
        gx = np.stack(gx_list)          # (Nb, K)
        gy = np.stack(gy_list)
        # sum-normalize: B_0 integrates to 1; B_n>0 integrate to 0.
        b0 = np.outer(gy[0], gx[0])
        s0 = b0.sum()
        self.b0_2d = (b0 / s0).astype(np.float32)
        # integral of each raw basis function; subtracting sums_n * b0_2d
        # (which integrates to 1) zeroes every B_n>0 integral
        sums = np.einsum('nk,nl->n', gy, gx)
        self.gx = jnp.asarray(gx, dtype=jnp.float32)
        self.gy = jnp.asarray(gy, dtype=jnp.float32)
        self.sums = jnp.asarray(sums, dtype=jnp.float32)
        self.nbasis = gx.shape[0]
        self.meta = meta

    def dense(self):
        """(Nb, K, K) dense sum-normalized basis (for tests / FFT paths)."""
        raw = _einsum_hi('nk,nl->nkl', self.gy, self.gx)
        b0 = jnp.asarray(self.b0_2d)
        out = raw.at[0].set(b0)
        corr = self.sums[:, None, None] * b0[None]
        return jnp.concatenate([out[:1], raw[1:] - corr[1:]], axis=0)


def spatial_terms(order):
    """(p, q) exponent list for a 2-D polynomial of total order ``order``."""
    return [(p, q) for o in range(order + 1) for p in range(o + 1)
            for q in [o - p]]


def _sep_conv_same(imgs, g_row, g_col):
    """Separable same-convolution: imgs (B, H, W), g_row/g_col (K,)."""
    B, H, W = imgs.shape
    K = g_row.shape[0]
    x = imgs[:, None]  # (B, 1, H, W)
    kr = g_row[None, None, :, None]
    kc = g_col[None, None, None, :]
    pad = (K // 2, (K - 1) // 2)
    hi = jax.lax.Precision.HIGHEST
    x = jax.lax.conv_general_dilated(x, kr, (1, 1), [pad, (0, 0)],
                                     dimension_numbers=('NCHW', 'OIHW',
                                                        'NCHW'),
                                     precision=hi)
    x = jax.lax.conv_general_dilated(x, kc, (1, 1), [(0, 0), pad],
                                     dimension_numbers=('NCHW', 'OIHW',
                                                        'NCHW'),
                                     precision=hi)
    return x[:, 0]


@partial(jax.jit, static_argnames=('stamp', 'order', 'nreg'))
def fit_kernel(ref, sci, ivar, xs, ys, svalid, basis_gx, basis_gy,
               basis_sums, b0_2d, frame_shape=None, stamp=31,
               order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Fit the spatially-varying PSF-matching kernel from star stamps.

    Parameters
    ----------
    ref, sci : (H, W) aligned frames (sci background-subtracted or not —
        the fitted constant background term absorbs any offset).
    ivar : (H, W) inverse variance of the *difference* (1/(var_sci+var_ref)).
    xs, ys : (S,) stamp centers (0-based pixel coords).
    svalid : (S,) bool, padding mask for the fixed stamp capacity.
    basis_* : from KernelBasis (gx/gy (Nb, K), sums (Nb,), b0_2d (K, K)).
    Returns dict with per-region coefficients ``coeffs`` (R2, Nb*Nm+1) where
    R2 = nreg*nreg (row-major region index), plus fit diagnostics.
    """
    H, W = ref.shape
    Nb, K = basis_gx.shape
    P = stamp
    Pi = P - K + 1                      # interior (valid conv) size
    terms = spatial_terms(order)
    Nm = len(terms)
    D = Nb * Nm + 1                     # + constant differential background

    xs = jnp.asarray(xs, jnp.float32)
    ys = jnp.asarray(ys, jnp.float32)
    x0 = jnp.clip(jnp.round(xs).astype(jnp.int32) - P // 2, 0, W - P)
    y0 = jnp.clip(jnp.round(ys).astype(jnp.int32) - P // 2, 0, H - P)

    def cutout(img, x0i, y0i):
        return jax.lax.dynamic_slice(img, (y0i, x0i), (P, P))

    R_s = jax.vmap(lambda a, b: cutout(ref, a, b))(x0, y0)      # (S, P, P)
    S_s = jax.vmap(lambda a, b: cutout(sci, a, b))(x0, y0)
    W_s = jax.vmap(lambda a, b: cutout(ivar, a, b))(x0, y0)
    # keep the cutout stamps OUT of the basis-convolution fusion: XLA
    # otherwise fuses the vmapped slices into a full-frame-height
    # convolution ((3080, 8, 384, 49) intermediates)
    R_s, S_s, W_s = jax.lax.optimization_barrier((R_s, S_s, W_s))

    # basis-convolved reference stamps C (S, Nb, Pi, Pi) via im2col + ONE
    # HIGHEST einsum: patches X (S, Pi, Pi, K*K) from K*K static slices
    # (tiny: S*Pi*Pi*225 floats), contracted against the dense basis
    # (Nb, K*K) — one matmul of shape M=S*Pi^2, K=225, N=Nb in place of
    # grouped separable 1-D convs at small channel counts.
    hi = jax.lax.Precision.HIGHEST
    X = jnp.stack([R_s[:, dy:dy + Pi, dx:dx + Pi]
                   for dy in range(K) for dx in range(K)],
                  axis=-1)                                   # (S,Pi,Pi,K*K)
    dense = _einsum_hi('nk,nl->nkl', basis_gy, basis_gx)     # (Nb, K, K)
    b0k = jnp.asarray(b0_2d)
    dense = jnp.concatenate(
        [b0k[None], dense[1:] - basis_sums[1:, None, None] * b0k[None]],
        axis=0)                                              # sum-normalized
    C = _einsum_hi('sijt,nt->snij', X, dense.reshape(Nb, K * K))

    off = K // 2
    y = S_s[:, off:off + Pi, off:off + Pi]
    w = W_s[:, off:off + Pi, off:off + Pi]

    # region assignment (row-major), one-hot over nreg*nreg
    rx = jnp.clip((xs * nreg / W).astype(jnp.int32), 0, nreg - 1)
    ry = jnp.clip((ys * nreg / H).astype(jnp.int32), 0, nreg - 1)
    rid = ry * nreg + rx                                         # (S,)
    R2 = nreg * nreg
    rhot = jax.nn.one_hot(rid, R2, dtype=jnp.float32)            # (S, R2)

    # spatial polynomial terms at stamp centers in REGION-LOCAL normalized
    # coords (global coords are nearly collinear inside one region third and
    # wreck the normal-matrix conditioning; hotpants also fits per-region)
    wx = W / (2.0 * nreg)
    wy = H / (2.0 * nreg)
    cx = (rx.astype(jnp.float32) + 0.5) * W / nreg
    cy = (ry.astype(jnp.float32) + 0.5) * H / nreg
    xn = (xs - cx) / wx
    yn = (ys - cy) / wy
    T = jnp.stack([(xn ** p) * (yn ** q) for p, q in terms], axis=1)  # (S,Nm)

    Cf = C.reshape(C.shape[0], Nb, Pi * Pi)
    yf = y.reshape(y.shape[0], Pi * Pi)
    wf = w.reshape(w.shape[0], Pi * Pi)

    # The dominant fit FLOPs — the per-stamp Gram blocks
    # CtC0[s] = C_s^T diag(w_s) C_s (S x (Nb,Pi^2)@(Pi^2,Nb), ~1.3 TFLOP
    # at the parity config) — do NOT depend on the rejection state:
    # stamp rejection enters only as a per-stamp {0,1} scalar, and
    # scaling by exact 0/1 commutes bit-for-bit with the p-contraction
    # in f32. Hoist them out of the 3-pass rejection loop (3x -> 1x).
    CtC0 = _einsum_hi('snp,sp,smp->snm', Cf, wf, Cf)             # (S,Nb,Nb)
    Cw0 = _einsum_hi('snp,sp->sn', Cf, wf)                       # (S,Nb)
    wsum0 = jnp.sum(wf, axis=1)                                  # (S,)
    TT = _einsum_hi('sm,sl->sml', T, T)                          # (S,Nm,Nm)

    def normal_eq(stamp_ok):
        okf = (stamp_ok & svalid).astype(jnp.float32)
        sw = wf * okf[:, None]
        # F_s[(p),(n,m)] = C[s,n,p] * T[s,m]; plus bg column of ones
        # G_s = F^T diag(w) F ; assembled with einsums, the ok
        # scalar folded into the stamp->region one-hot
        rhow = rhot * okf[:, None]                               # (S, R2)
        G_bb = _einsum_hi('snm,skl,sr->rnkml', CtC0, TT, rhow)
        G_bb = G_bb.reshape(R2, Nb * Nm, Nb * Nm)
        G_bg = _einsum_hi('sn,sm,sr->rnm', Cw0, T, rhow).reshape(
            R2, Nb * Nm)
        wsum = _einsum_hi('s,sr->r', wsum0, rhow)
        G = jnp.zeros((R2, D, D))
        G = G.at[:, :Nb * Nm, :Nb * Nm].set(G_bb)
        G = G.at[:, :Nb * Nm, -1].set(G_bg)
        G = G.at[:, -1, :Nb * Nm].set(G_bg)
        G = G.at[:, -1, -1].set(wsum)
        return G, sw

    def rhs(yvec, sw):
        """F^T diag(w) yvec, assembled per region."""
        Cy = _einsum_hi('snp,sp->sn', Cf, sw * yvec)
        h_b = _einsum_hi('sn,sm,sr->rnm', Cy, T, rhot).reshape(R2, Nb * Nm)
        h_g = _einsum_hi('sp,sr->r', sw * yvec, rhot)
        return jnp.concatenate([h_b, h_g[:, None]], axis=1)

    def model_stamps(coeffs):
        a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
        bg = coeffs[:, -1]
        a_s = _einsum_hi('sr,rnm->snm', rhot, a)
        bg_s = _einsum_hi('sr,r->s', rhot, bg)
        wmap = _einsum_hi('snm,sm->sn', a_s, T)                  # (S,Nb)
        return _einsum_hi('sn,snp->sp', wmap, Cf) + bg_s[:, None]

    # order-weighted spatial ridge: ~40 stamp positions sample the Nm
    # spatial terms, so the high-order polynomial coefficients are barely
    # constrained and chase per-stamp warp-phase noise — the fitted
    # surface then explodes past the stamp hull (r4 scene: kernel sum
    # dropped 35% within 40 px of the last stamp, flooding the region
    # edge with false detections). Penalize term (p, q) by
    # RIDGE_GROWTH^(p+q) on the Jacobi-normalized diagonal: constant and
    # linear variation pass freely, quartic terms need strong evidence.
    # hotpants counters the same instability with ~100 substamps/region.
    # default growth 4 (r5, tests/test_ridge_bias.py sweep): at the
    # production config (order 4, ~40 stamps/region) growth 8 biased the
    # B0 photometric field 1.4 mmag vs the unregularized float64 oracle
    # (quartic penalty 8^4*1e-5 ~ 0.04); growth 4 measures 0.84 mmag
    # there while still damping the region-edge surface blowup growth
    # was introduced for (tests/test_night_scene.py guards it).
    # ZUDS_FIT_RIDGE_GROWTH=0 restores the flat ridge.
    # base 1e-5 (Jacobi-normalized, so 1e-5 of each column's own scale):
    # at 1e-7 the KERNEL-basis block is unpinned when few stamps
    # constrain it — kappa*eps_f32 ~ O(1), and ulp-level input changes
    # swung the coefficient vector by O(10) along near-null directions
    # (stamp chi2 moved 0.002) while the off-stamp model wandered ~4
    # counts across the frame (r4, preroll-bucket cross-path test). 1e-5
    # caps kappa at ~1e5, pinning the off-stamp model, and measures <1
    # mmag vs the unregularized float64 oracle (well-constrained
    # directions shift by ~1e-5 relative).
    import os as _os
    base_l = float(_os.environ.get('ZUDS_FIT_RIDGE', '1e-5'))
    growth = float(_os.environ.get('ZUDS_FIT_RIDGE_GROWTH', '4'))
    t_ord = np.asarray([p + q for p, q in terms], np.float32)
    lam_col = np.full(D, base_l, np.float32)
    if growth > 0:
        lam_nm = (base_l * growth ** t_ord)[None, :].repeat(Nb, 0).ravel()
        lam_col = np.concatenate([lam_nm, [base_l]]).astype(np.float32)
    lam_col = jnp.asarray(lam_col)

    def solve_factory(G):
        # Jacobi-scaled ridge operator: normalize columns to unit diagonal
        # so the tiny regularizer is scale-free (raw G mixes flux^2-sized
        # kernel entries with O(npix) background entries)
        d = jax.vmap(jnp.diag)(G)                                # (R2, D)
        sc = 1.0 / jnp.sqrt(jnp.maximum(d, 1e-20))
        Gr = (G * sc[:, :, None] * sc[:, None, :]
              + jnp.diag(lam_col)[None])

        def solve(h):
            return jax.vmap(jnp.linalg.solve)(Gr, h * sc) * sc
        return solve

    def stamp_chi2(coeffs):
        a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
        bg = coeffs[:, -1]
        a_s = _einsum_hi('sr,rnm->snm', rhot, a)
        bg_s = _einsum_hi('sr,r->s', rhot, bg)
        wmap = _einsum_hi('snm,sm->sn', a_s, T)                  # (S,Nb)
        model = _einsum_hi('sn,snp->sp', wmap, Cf) + bg_s[:, None]
        resid2 = (model - yf) ** 2 * wf
        npix = jnp.maximum(jnp.sum(wf > 0, axis=1), 1)
        return jnp.sum(resid2, axis=1) / npix                    # (S,)

    ok = jnp.ones(xs.shape[0], dtype=bool)
    coeffs = None
    for _ in range(3):                 # 2 rejection passes + final fit
        G, sw = normal_eq(ok)
        solve = solve_factory(G)
        coeffs = solve(rhs(yf, sw))
        # TWO data-space refinement steps: the f32 Gram squares the design
        # condition number, and a single solve leaves multi-mmag bias on
        # the photometric B0 coefficient. Computing the residual in DATA
        # space (y - F z: small numbers before the big contraction)
        # sidesteps the catastrophic h - G z cancellation; each step cuts
        # the error by ~kappa*eps_f32 (tests/test_parity.py pins <1 mmag
        # against a float64 oracle). When kappa*eps >= 1 refinement can
        # DIVERGE, so each step is accepted per region only if it lowers
        # the weighted chi2 — monotone by construction.
        def region_chi2(c):
            r2v = (model_stamps(c) - yf) ** 2 * sw
            return _einsum_hi('sp,sr->r', r2v, rhot)

        for _r in range(2):
            resid = yf - model_stamps(coeffs)
            cand = coeffs + solve(rhs(resid, sw))
            better = (region_chi2(cand) <= region_chi2(coeffs))
            coeffs = jnp.where(better[:, None], cand, coeffs)
        chi2 = stamp_chi2(coeffs)
        live = ok & svalid
        # per-region 3-sigma clip (a bad region's stamps must not be judged
        # against well-fit regions, and vice versa)
        new_ok = jnp.zeros_like(ok)
        for r in range(R2):
            inr = live & (rid == r)
            med = jnp.nanmedian(jnp.where(inr, chi2, jnp.nan))
            med = jnp.nan_to_num(med, nan=1.0)
            mad = jnp.nanmedian(jnp.where(inr, jnp.abs(chi2 - med), jnp.nan))
            mad = jnp.nan_to_num(mad, nan=1.0)
            keep = chi2 <= med + 3.0 * 1.4826 * jnp.maximum(mad, 1e-12)
            new_ok = new_ok | ((rid == r) & keep)
        ok = new_ok

    chi2 = stamp_chi2(coeffs)
    return {'coeffs': coeffs, 'stamp_ok': ok & svalid, 'stamp_chi2': chi2,
            'nb': Nb, 'nm': Nm}


def _basis_layout(degrees):
    """Static (sigma, p, q) layout of the KernelBasis construction order,
    plus the unique column-kernel (sigma, p) and row-kernel (sigma, q)
    factors with a representative basis row index for each."""
    meta = []
    for si, deg in enumerate(degrees):
        for p in range(deg + 1):
            for q in range(deg + 1 - p):
                meta.append((si, p, q))
    col_rep, row_rep = {}, {}
    for n, (si, p, q) in enumerate(meta):
        col_rep.setdefault((si, p), n)
        row_rep.setdefault((si, q), n)
    cols = list(col_rep)
    return meta, cols, col_rep


def apply_kernel_fast(ref, coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                      order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE,
                      degrees=KERNEL_GAUSS_DEGREES):
    """Apply-formulation dispatcher: the space-to-depth matmul form
    (:func:`apply_kernel_s2d`) where the frame tiles into 8x8 cells, else
    the grouped separable conv (:func:`apply_kernel`). Kept as the single
    call site so an A/B on the card (PERF.md) can swap the winner."""
    H, W = ref.shape
    if H % 8 == 0 and W % 8 == 0 and basis_gx.shape[1] <= 17:
        return apply_kernel_s2d(ref, coeffs, basis_gx, basis_gy,
                                basis_sums, b0_2d, order=order, nreg=nreg)
    return apply_kernel(ref, coeffs, basis_gx, basis_gy, basis_sums,
                        b0_2d, order=order, nreg=nreg)


def _s2d(img, d=8):
    """Space-to-depth: (H, W) -> (H/d, W/d, d*d), channel = cy*d + cx."""
    H, W = img.shape
    z = img.reshape(H // d, d, W // d, d)
    return jnp.transpose(z, (0, 2, 1, 3)).reshape(H // d, W // d, d * d)


def _inv_s2d(z, d=8):
    HY, WX, _ = z.shape
    z = z.reshape(HY, WX, d, d)
    return jnp.transpose(z, (0, 2, 1, 3)).reshape(HY * d, WX * d)


@partial(jax.jit, static_argnames=('order', 'nreg'))
def apply_kernel_s2d(ref, coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                     order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Matmul-shaped apply: space-to-depth dense conv per region panel.

    The grouped separable conv streams 2*Nb 1-D convs at small channel
    counts, which a matrix unit cannot use. So: fold the 49-function basis and the
    per-region spatial-term coefficients into Nm dense 15x15 kernels per
    region, pack the frame (H, W) -> (H/8, W/8, 64) space-to-depth, and
    run each region's panel as ONE 3x3 x 64 -> 64*Nm NHWC conv (the
    CNN shape the emitter tiles well), then blend the Nm term channels
    with the local polynomial fields and unpack. Exact zero-pad 'same'
    semantics at frame borders; interior panel edges read real
    neighboring cells from the globally padded pack, so the result is
    bit-comparable to :func:`apply_kernel` (tests/test_subtract.py pins
    <1e-4 relative). The one matmul runs in f32 at HIGHEST precision.

    Reference config: hotpants -ko 4 -nrx 3 -nry 3
    (zuds/hotpants.py:77-93).
    """
    import math
    H, W = ref.shape
    Nb, K = basis_gx.shape
    assert H % 8 == 0 and W % 8 == 0 and K <= 17
    terms = spatial_terms(order)
    Nm = len(terms)
    R2 = nreg * nreg
    a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
    bg = coeffs[:, -1]

    # dense sum-normalized basis -> per-(region, term) kernels on device
    raw = _einsum_hi('nk,nl->nkl', basis_gy, basis_gx)        # (Nb, K, K)
    b0 = jnp.asarray(b0_2d)
    dense = jnp.concatenate(
        [b0[None], raw[1:] - basis_sums[1:, None, None] * b0[None]], axis=0)
    kd = _einsum_hi('rnm,nkl->rmkl', a, dense)                # (R2,Nm,K,K)
    # pad K up to 17 so the 3x3-block fold below always covers the support
    if K < 17:
        p = (17 - K) // 2
        kd = jnp.pad(kd, ((0, 0), (0, 0), (p, p), (p, p)))
    KP = 17
    r = KP // 2

    # fold kernels into the s2d conv weight (3, 3, 64, 64*Nm) per region:
    # out channel co*Nm+m at s2d cell offset (co//8, co%8) reads input
    # channel ci of block (dY, dX) with weight kd[m, ky, kx] where
    # iy = (dY-1)*8 + ci//8 = co//8 + ky - r (likewise x). All index
    # algebra is STATIC numpy -> the fold is one fixed-index gather.
    dY_i, dX_i, ci_i, co_i = np.meshgrid(
        np.arange(3), np.arange(3), np.arange(64), np.arange(64),
        indexing='ij')
    ky_m = (dY_i - 1) * 8 + ci_i // 8 - co_i // 8 + r
    kx_m = (dX_i - 1) * 8 + ci_i % 8 - co_i % 8 + r
    valid = ((ky_m >= 0) & (ky_m < KP) & (kx_m >= 0)
             & (kx_m < KP))                                   # (3,3,64,64)
    kyc = jnp.asarray(np.clip(ky_m, 0, KP - 1))
    kxc = jnp.asarray(np.clip(kx_m, 0, KP - 1))
    gath = kd[:, :, kyc, kxc]                        # (R2, Nm, 3,3,64,64)
    gath = jnp.where(jnp.asarray(valid)[None, None], gath, 0.0)
    wbig = gath.transpose(0, 2, 3, 4, 5, 1).reshape(
        R2, 3, 3, 64, 64 * Nm)

    z = _s2d(ref)                                             # (HY, WX, 64)
    HY, WX = z.shape[:2]

    y_edges = [int(math.ceil(i * H / nreg)) for i in range(nreg)] + [H]
    x_edges = [int(math.ceil(i * W / nreg)) for i in range(nreg)] + [W]
    # aligned panel bounds per region (s2d cells)
    pan = []
    for ri in range(nreg):
        y0, y1 = y_edges[ri], y_edges[ri + 1]
        for rj in range(nreg):
            x0, x1 = x_edges[rj], x_edges[rj + 1]
            pan.append(((y0 // 8), -(-y1 // 8), (x0 // 8), -(-x1 // 8)))
    PYm = max(p[1] - p[0] for p in pan)
    PXm = max(p[3] - p[2] for p in pan)
    # pad once so every (PYm+2, PXm+2) halo window is in-bounds
    ey = max(p[0] + PYm + 1 for p in pan) - HY
    ex = max(p[2] + PXm + 1 for p in pan) - WX
    zp = jnp.pad(z, ((1, 1 + max(ey, 0)), (1, 1 + max(ex, 0)), (0, 0)))

    # im2col in s2d space: X (R2, PYm*PXm, 9*64) — 9 shifted (PYm, PXm)
    # views per panel, channel order (dY, dX, ci) matching wbig's fold
    cols = []
    for (cy0, _, cx0, _) in pan:
        shifts = [zp[cy0 + dY:cy0 + dY + PYm, cx0 + dX:cx0 + dX + PXm]
                  for dY in range(3) for dX in range(3)]
        cols.append(jnp.concatenate(shifts, axis=-1))        # (PYm,PXm,576)
    X = jnp.stack(cols).reshape(R2, PYm * PXm, 9 * 64)
    wmat = wbig.reshape(R2, 9 * 64, 64 * Nm)

    # ONE batched matmul (M=PYm*PXm, K=576, N=64*Nm) in place of
    # per-panel convs: the identical FLOPs as large regular tiles
    out = _einsum_hi('rps,rsn->rpn', X, wmat)
    out = out.reshape(R2, PYm, PXm, 64, Nm)

    wx_h = W / (2.0 * nreg)
    wy_h = H / (2.0 * nreg)
    yy_full = jnp.arange(H, dtype=jnp.float32)
    xx_full = jnp.arange(W, dtype=jnp.float32)

    rows = []
    for ri in range(nreg):
        row = []
        y0, y1 = y_edges[ri], y_edges[ri + 1]
        for rj in range(nreg):
            rr = ri * nreg + rj
            x0, x1 = x_edges[rj], x_edges[rj + 1]
            cy0, cy1, cx0, cx1 = pan[rr]
            PY, PX = cy1 - cy0, cx1 - cx0
            ya0, xa0 = cy0 * 8, cx0 * 8
            # local spatial-term fields on the panel's pixel grid
            xn_l = ((xx_full[xa0:xa0 + PX * 8] - (rj + 0.5) * W / nreg)
                    / wx_h)[None, :]
            yn_l = ((yy_full[ya0:ya0 + PY * 8] - (ri + 0.5) * H / nreg)
                    / wy_h)[:, None]
            P = jnp.stack([(xn_l ** p) * (yn_l ** q) for p, q in terms],
                          axis=-1)                           # (PH,PW,Nm)
            Pz = P.reshape(PY, 8, PX, 8, Nm).transpose(0, 2, 1, 3, 4)
            blended = (out[rr, :PY, :PX]
                       * Pz.reshape(PY, PX, 64, Nm)).sum(-1)
            m_r = _inv_s2d(blended) + bg[rr]
            row.append(m_r[y0 - ya0:y0 - ya0 + (y1 - y0),
                           x0 - xa0:x0 - xa0 + (x1 - x0)])
        rows.append(jnp.concatenate(row, axis=1))
    return jnp.concatenate(rows, axis=0)


@partial(jax.jit, static_argnames=('order', 'nreg'))
def apply_kernel(ref, coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                 order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Convolve ``ref`` with the fitted spatially-varying kernel + background.

    Returns the model frame  sum_nm a_nm(region) T_m(x,y) (B_n * R) + bg.
    Memory-bounded: accumulates over basis functions with a scan; the 3x3
    regions share every convolution and differ only in coefficient fields.
    """
    H, W = ref.shape
    Nb, K = basis_gx.shape
    terms = spatial_terms(order)
    Nm = len(terms)
    R2 = nreg * nreg
    a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
    bg = coeffs[:, -1]

    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    rx = jnp.clip((xx * nreg / W).astype(jnp.int32), 0, nreg - 1)
    ry = jnp.clip((yy * nreg / H).astype(jnp.int32), 0, nreg - 1)
    rid = (ry * nreg + rx)                                       # (H, W)
    # region-local normalized coordinates (must match fit_kernel)
    wx = W / (2.0 * nreg)
    wy = H / (2.0 * nreg)
    cx = (rx.astype(jnp.float32) + 0.5) * W / nreg
    cy = (ry.astype(jnp.float32) + 0.5) * H / nreg
    xn = (xx - cx) / wx
    yn = (yy - cy) / wy

    pexp = jnp.asarray([p for p, q in terms], jnp.int32)
    qexp = jnp.asarray([q for p, q in terms], jnp.int32)

    # Fold the basis sum-normalization into COEFFICIENT space so the convs
    # run on the raw separable basis:
    #   sum_nm a_nm C_norm_n = sum_nm a~_nm C_raw_n  with
    #   a~_0m = (a_0m - sum_{n>=1} a_nm sums_n)/s0,  a~_nm = a_nm (n>=1).
    s0 = jnp.sum(basis_gy[0]) * jnp.sum(basis_gx[0])
    a0 = (a[:, 0, :] - _einsum_hi('rnm,n->rm', a[:, 1:, :],
                                  basis_sums[1:])) / s0
    a_t = jnp.concatenate([a0[:, None, :], a[:, 1:, :]], axis=1)

    # static region rectangles (identical assignment rule to fit_kernel's
    # rid = floor(coord * nreg / extent))
    import math
    y_edges = [int(math.ceil(r * H / nreg)) for r in range(nreg)] + [H]
    x_edges = [int(math.ceil(r * W / nreg)) for r in range(nreg)] + [W]

    # raw basis convolutions as chunked grouped separable convs (one
    # launch per chunk, not a python loop of single-channel 1-D convs);
    # combination over the basis dimension is a small matmul per static
    # region slice — zero mask fields.
    hi = jax.lax.Precision.HIGHEST
    pad = (K // 2, (K - 1) // 2)
    CHUNK = 49
    x = ref[None, None]                                      # (1,1,H,W)
    # per-region spatial-term accumulators E_r: (Nm, h_r, w_r)
    E = [[None for _ in range(nreg)] for _ in range(nreg)]
    for c0 in range(0, Nb, CHUNK):
        c1 = min(c0 + CHUNK, Nb)
        nch = c1 - c0
        kr = basis_gy[c0:c1, None, :, None]                  # (nch,1,K,1)
        kc = basis_gx[c0:c1, None, None, :]
        t = jax.lax.conv_general_dilated(
            x, kr, (1, 1), [pad, (0, 0)],
            dimension_numbers=('NCHW', 'OIHW', 'NCHW'), precision=hi)
        t = jax.lax.conv_general_dilated(
            t, kc, (1, 1), [(0, 0), pad],
            dimension_numbers=('NCHW', 'OIHW', 'NCHW'),
            feature_group_count=nch, precision=hi)[0]        # (nch,H,W)
        for ri in range(nreg):
            for rj in range(nreg):
                r = ri * nreg + rj
                sl = (slice(None), slice(y_edges[ri], y_edges[ri + 1]),
                      slice(x_edges[rj], x_edges[rj + 1]))
                part = _einsum_hi('nhw,nm->mhw', t[sl], a_t[r, c0:c1, :])
                E[ri][rj] = part if E[ri][rj] is None else E[ri][rj] + part

    # assemble: model[region] = sum_m T_m(local coords) * E_r[m] + bg_r
    rows = []
    for ri in range(nreg):
        row = []
        for rj in range(nreg):
            r = ri * nreg + rj
            ys = yy[y_edges[ri]:y_edges[ri + 1]]
            xs_ = xx[:, x_edges[rj]:x_edges[rj + 1]]
            xn_l = (xs_ - (rj + 0.5) * W / nreg) / wx
            yn_l = (ys - (ri + 0.5) * H / nreg) / wy
            m_r = jnp.zeros_like(E[ri][rj][0]) + bg[r]
            for m, (p, q) in enumerate(terms):
                m_r = m_r + (xn_l ** p) * (yn_l ** q) * E[ri][rj][m]
            row.append(m_r)
        rows.append(jnp.concatenate(row, axis=1))
    return jnp.concatenate(rows, axis=0)


def subtract_frames(sci, ref_aligned, sci_rms, ref_rms, badmask, fit,
                    basis, order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Full difference: D = sci - (K*ref + bg), noise map, nodata sentinel.

    ``fit`` is the output of fit_kernel. Bad pixels (``badmask`` True) are
    filled with SUB_NODATA_SENTINEL, mirroring hotpants' 1e-30 fill consumed
    by the reference (``zuds/subtraction.py:167-177``).
    """
    model = apply_kernel_fast(ref_aligned, fit['coeffs'], basis.gx,
                              basis.gy, basis.sums, basis.b0_2d,
                              order=order, nreg=nreg)
    diff = sci - model
    # noise propagation with the region-center kernels
    var = sci_rms ** 2 + _propagate_ref_var(ref_rms, fit, basis, order, nreg,
                                            sci.shape)
    rms = jnp.sqrt(var)
    rms = jnp.where(badmask, BIG_RMS, rms)
    diff = jnp.where(badmask, SUB_NODATA_SENTINEL, diff)
    return diff, rms


def center_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                   order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """(R2, K, K) dense PSF-matching kernel evaluated at each region center.

    The region center is the origin of the region-local spatial polynomial,
    so only the (0, 0) term contributes; the sum-normalized basis is
    reassembled from the separable tables."""
    Nb, K = basis_gx.shape
    terms = spatial_terms(order)
    Nm = len(terms)
    R2 = nreg * nreg
    a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
    raw = _einsum_hi('nk,nl->nkl', basis_gy, basis_gx)           # (Nb, K, K)
    b0 = jnp.asarray(b0_2d)
    dense = jnp.concatenate(
        [b0[None], raw[1:] - basis_sums[1:, None, None] * b0[None]], axis=0)
    return _einsum_hi('rn,nkl->rkl', a[:, :, 0], dense)          # (R2, K, K)


def propagate_ref_var(ref_rms, coeffs, basis_gx, basis_gy, basis_sums,
                      b0_2d, order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """conv(var_ref, K_r^2) with K evaluated at each region center —
    hotpants' noise-image propagation (its ``-oni`` output convolves the
    template variance with the squared kernel; zuds/hotpants.py:81).

    Cost note: runs one 'valid' conv per STATIC region slice (zero-padded
    at frame edges), totalling a single full-frame KxK conv of work — the
    naive form (R2 full-frame convs + masked select) costs R2x more."""
    import math
    H, W = ref_rms.shape
    K = basis_gx.shape[1]
    r = K // 2
    kerns = center_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                           order=order, nreg=nreg)
    var = ref_rms ** 2
    varp = jnp.pad(var, r)
    y_edges = [int(math.ceil(i * H / nreg)) for i in range(nreg)] + [H]
    x_edges = [int(math.ceil(i * W / nreg)) for i in range(nreg)] + [W]
    rows = []
    for ri in range(nreg):
        row = []
        y0, y1 = y_edges[ri], y_edges[ri + 1]
        for rj in range(nreg):
            x0, x1 = x_edges[rj], x_edges[rj + 1]
            k2 = (kerns[ri * nreg + rj] ** 2)[None, None]
            sl = varp[y0:y1 + 2 * r, x0:x1 + 2 * r][None, None]
            c = jax.lax.conv_general_dilated(
                sl, k2, (1, 1), [(0, 0), (0, 0)],
                dimension_numbers=('NCHW', 'OIHW', 'NCHW'),
                precision=jax.lax.Precision.HIGHEST)[0, 0]
            row.append(c)
        rows.append(jnp.concatenate(row, axis=1))
    return jnp.concatenate(rows, axis=0)


def _propagate_ref_var(ref_rms, fit, basis, order, nreg, shape):
    """Back-compat shim over :func:`propagate_ref_var` (object basis)."""
    return propagate_ref_var(ref_rms, fit['coeffs'], basis.gx, basis.gy,
                             basis.sums, jnp.asarray(basis.b0_2d),
                             order=order, nreg=nreg)
