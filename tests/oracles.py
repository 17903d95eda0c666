"""Plain float64 references for the device ops (no zuds_tpu imports).

Each oracle implements the published algorithm — Lanczos-3 interpolation,
the Gruen et al. 2014 CLIPPED combine, the Alard & Lupton 1998 least-squares
kernel fit, 8-connected component labeling, exact-overlap circular
apertures — directly in NumPy/SciPy, sharing no code with
``zuds_tpu.ops``. ``tests/test_parity.py`` checks the ops against them at
small sizes on the CPU; ``chip_smoke.py`` checks them at full quadrant size
on the card. Tolerances are those of ``docs/PARITY_CONTRACT.md``.
"""
import numpy as np

MMAG = 1e-3 * np.log(10) / 2.5          # 1 mmag as a relative flux error


def oracle_lanczos3(t):
    t = np.asarray(t, float)
    out = np.sinc(t) * np.sinc(t / 3.0)
    return np.where(np.abs(t) < 3.0, out, 0.0)


def oracle_warp(img, u, v):
    """Direct 6x6-tap Lanczos-3 interpolation, float64, weights
    renormalized to unit sum (the documented SWarp deviation of
    ops/resample.py)."""
    H, W = img.shape
    out = np.zeros(u.shape)
    wsum = np.zeros(u.shape)
    iu = np.floor(u).astype(int)
    iv = np.floor(v).astype(int)
    fu = u - iu
    fv = v - iv
    inb = ((iu - 2 >= 0) & (iu + 3 <= W - 1)
           & (iv - 2 >= 0) & (iv + 3 <= H - 1))
    iuc = np.clip(iu, 2, W - 4)
    ivc = np.clip(iv, 2, H - 4)
    for dy in range(-2, 4):
        wy = oracle_lanczos3(fv - dy)
        for dx in range(-2, 4):
            w = oracle_lanczos3(fu - dx) * wy
            out += img[ivc + dy, iuc + dx] * w
            wsum += w
    out = out / np.where(wsum == 0, 1.0, wsum)
    return out * inb, inb.astype(float)


def oracle_clipped_coadd(imgs, weights, scales=None, nsigma=4.0,
                         amp_frac=0.3):
    """CLIPPED weighted-mean combine (Gruen et al. 2014 semantics as
    specified in ops/coadd.py), float64. The median is over the epochs
    with positive weight (0 where there are none)."""
    imgs = np.asarray(imgs, float).copy()
    weights = np.asarray(weights, float).copy()
    if scales is not None:
        imgs *= np.asarray(scales, float)[:, None, None]
        weights /= np.asarray(scales, float)[:, None, None] ** 2
    ok = weights > 0
    sigma = np.where(ok, 1.0 / np.sqrt(np.maximum(weights, 1e-30)), np.inf)
    any_ok = ok.any(axis=0)
    masked = np.where(ok, imgs, np.nan)
    masked[:, ~any_ok] = 0.0
    med = np.nanmedian(masked, axis=0)
    keep = ok & (np.abs(imgs - med[None]) <= nsigma * sigma
                 + amp_frac * np.abs(med)[None])
    wsum = np.sum(np.where(keep, weights, 0.0), axis=0)
    csum = np.sum(np.where(keep, weights * imgs, 0.0), axis=0)
    return np.where(wsum > 0, csum / np.where(wsum > 0, wsum, 1), 0.0), wsum


def spatial_terms(order):
    """(p, q) exponents of a 2-D polynomial of total order ``order``, in the
    coefficient layout of the kernel fit (term m of basis n is column
    n * Nm + m)."""
    return [(p, o - p) for o in range(order + 1) for p in range(o + 1)]


def _region_coords(x, y, shape, nreg):
    """Region index (row-major) and region-local normalized coordinates
    in [-1, 1] — hotpants fits each of the nreg x nreg regions on its own
    (-nrx/-nry)."""
    H, W = shape
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    rx = np.clip((x * nreg / W).astype(int), 0, nreg - 1)
    ry = np.clip((y * nreg / H).astype(int), 0, nreg - 1)
    xn = (x - (rx + 0.5) * W / nreg) / (W / (2.0 * nreg))
    yn = (y - (ry + 0.5) * H / nreg) / (H / (2.0 * nreg))
    return ry * nreg + rx, xn, yn


def oracle_al_fit(ref, sci, ivar, xs, ys, basis_dense, stamp, order=0,
                  nreg=1):
    """Alard-Lupton kernel fit by dense float64 least squares: model
    sci ~ sum_nm a_nm T_m(x, y) (B_n * ref) + bg over star stamps, each of
    the nreg x nreg regions solved on its own with lstsq on the weighted
    design — no normal equations, no regularization, no device code.
    Stamp-center polynomial terms in region-local coordinates. Returns
    (nreg*nreg, Nb*Nm + 1) coefficients (a region without stamps is 0)."""
    from numpy.lib.stride_tricks import sliding_window_view
    Nb, K, _ = basis_dense.shape
    P = stamp
    Pi = P - K + 1
    terms = spatial_terms(order)
    Nm = len(terms)
    rid, xn, yn = _region_coords(xs, ys, ref.shape, nreg)
    dense2 = basis_dense.reshape(Nb, K * K).T.astype(float)
    rows = [[] for _ in range(nreg * nreg)]
    targ = [[] for _ in range(nreg * nreg)]
    wts = [[] for _ in range(nreg * nreg)]
    off = K // 2
    H, W = ref.shape
    for i, (x, y) in enumerate(zip(xs, ys)):
        # a stamp near the frame edge is moved inside it, not cut
        x0 = min(max(int(round(x)) - P // 2, 0), W - P)
        y0 = min(max(int(round(y)) - P // 2, 0), H - P)
        R = ref[y0:y0 + P, x0:x0 + P].astype(float)
        S = sci[y0:y0 + P, x0:x0 + P].astype(float)
        V = ivar[y0:y0 + P, x0:x0 + P].astype(float)
        # valid cross-correlation of R with each basis (matches
        # lax.conv_general_dilated orientation: no kernel flip)
        windows = sliding_window_view(R, (K, K)).reshape(Pi * Pi, K * K)
        C = (windows @ dense2).T                            # (Nb, Pi*Pi)
        T = np.array([xn[i] ** p * yn[i] ** q for p, q in terms])
        F = (C[:, None, :] * T[None, :, None]).reshape(Nb * Nm, -1)
        rows[rid[i]].append(
            np.concatenate([F, np.ones((1, Pi * Pi))], axis=0).T)
        targ[rid[i]].append(S[off:off + Pi, off:off + Pi].ravel())
        wts[rid[i]].append(V[off:off + Pi, off:off + Pi].ravel())
    out = np.zeros((nreg * nreg, Nb * Nm + 1))
    for r in range(nreg * nreg):
        if not rows[r]:
            continue
        A = np.concatenate(rows[r], axis=0)
        b = np.concatenate(targ[r])
        w = np.sqrt(np.concatenate(wts[r]))
        out[r], *_ = np.linalg.lstsq(A * w[:, None], b * w, rcond=None)
    return out


def oracle_b0_field(coeffs, xs, ys, shape, nbasis, order, nreg):
    """Photometric flux-ratio (kernel sum) field at positions: only B0 of
    the sum-normalized basis carries it."""
    terms = spatial_terms(order)
    Nm = len(terms)
    rid, xn, yn = _region_coords(xs, ys, shape, nreg)
    a0 = coeffs[:, :nbasis * Nm].reshape(-1, nbasis, Nm)[rid, 0, :]
    T = np.stack([xn ** p * yn ** q for p, q in terms], axis=1)
    return np.sum(a0 * T, axis=1)


def oracle_al_model(ref, coeffs, basis_dense, order, nreg, window):
    """Model frame sum_nm a_nm(region) T_m(x, y) (B_n * ref) + bg_region
    over ``window`` = (y0, y1, x0, x1) of the frame, float64, by FFT
    cross-correlation with zero padding at the frame edge."""
    from scipy.signal import fftconvolve
    H, W = ref.shape
    Nb, K, _ = basis_dense.shape
    r = K // 2
    y0, y1, x0, x1 = window
    pad = np.zeros((y1 - y0 + 2 * r, x1 - x0 + 2 * r))
    sy0, sy1 = max(y0 - r, 0), min(y1 + r, H)
    sx0, sx1 = max(x0 - r, 0), min(x1 + r, W)
    pad[sy0 - (y0 - r):sy1 - (y0 - r), sx0 - (x0 - r):sx1 - (x0 - r)] = \
        ref[sy0:sy1, sx0:sx1]
    terms = spatial_terms(order)
    Nm = len(terms)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    rid, xn, yn = _region_coords(xx.ravel(), yy.ravel(), (H, W), nreg)
    rid = rid.reshape(xx.shape)
    T = [(xn ** p * yn ** q).reshape(xx.shape) for p, q in terms]
    a = coeffs[:, :Nb * Nm].reshape(-1, Nb, Nm)
    model = coeffs[rid, -1].astype(float)
    for n in range(Nb):
        conv = fftconvolve(pad, basis_dense[n][::-1, ::-1].astype(float),
                           mode='valid')
        field = sum(a[rid, n, m] * T[m] for m in range(Nm))
        model += field * conv
    return model


def oracle_labels(mask):
    """8-connected component labels (scipy.ndimage), 0 = background."""
    from scipy import ndimage
    lab, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    return lab, n


def same_partition(lab_ref, lab_dev, mask):
    """True when ``lab_dev`` splits the pixels of ``mask`` into exactly
    the components of ``lab_ref`` (labels may differ by a renaming).
    Returns (equal, n_ref_components, n_dev_components)."""
    a = lab_ref[mask].astype(np.int64)
    b = lab_dev[mask].astype(np.int64)
    na = len(np.unique(a))
    nb = len(np.unique(b))
    pairs = len(np.unique(a * (int(b.max(initial=0)) + 1) + b))
    return pairs == na == nb, na, nb


def _overlap_quadrature(dx, dy, r, nodes=2048):
    """Area of the unit pixel centered at (dx, dy) inside the circle of
    radius r at the origin: the pixel's chord length integrated over x
    by a composite midpoint rule (float64)."""
    t = (np.arange(nodes) + 0.5) / nodes - 0.5                # (nodes,)
    x = dx[:, None] + t[None, :]
    h = np.sqrt(np.maximum(r * r - x * x, 0.0))
    lo = np.maximum(dy[:, None] - 0.5, -h)
    hi = np.minimum(dy[:, None] + 0.5, h)
    return np.maximum(hi - lo, 0.0).mean(axis=1)


def oracle_aperture(img, xs, ys, r):
    """Circular-aperture sums at (xs, ys) with exact pixel overlap
    weights: pixels wholly inside (outside) the circle weigh 1 (0), the
    rest are integrated numerically. Returns (flux, sum |pixel| * weight)
    — the second is the scale a flux error is judged against."""
    img = np.asarray(img, float)
    H, W = img.shape
    half = int(np.ceil(r)) + 1
    offs = np.arange(-half, half + 1)
    flux = np.zeros(len(xs))
    absflux = np.zeros(len(xs))
    for i, (xc, yc) in enumerate(zip(xs, ys)):
        px = np.round(xc).astype(int) + offs
        py = np.round(yc).astype(int) + offs
        gx, gy = np.meshgrid(px, py)
        dx = (gx - xc).ravel()
        dy = (gy - yc).ravel()
        near = np.sqrt(np.maximum(np.abs(dx) - 0.5, 0) ** 2
                       + np.maximum(np.abs(dy) - 0.5, 0) ** 2)
        far = np.sqrt((np.abs(dx) + 0.5) ** 2 + (np.abs(dy) + 0.5) ** 2)
        w = np.where(far <= r, 1.0, 0.0)
        edge = (near < r) & (far > r)
        w[edge] = _overlap_quadrature(dx[edge], dy[edge], r)
        inside = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)
        pix = np.where(inside, img[np.clip(gy, 0, H - 1),
                                   np.clip(gx, 0, W - 1)], 0.0).ravel()
        flux[i] = np.sum(pix * w)
        absflux[i] = np.sum(np.abs(pix) * w)
    return flux, absflux
