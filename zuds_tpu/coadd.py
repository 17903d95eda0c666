"""Coaddition pipeline step (reference: zuds/coadd.py).

``Coadd.from_images`` keeps the reference's transaction shape (validate ->
prepare inputs -> combine -> set masks/headers -> seeing -> persist) but the
middle is a device program: Lanczos-3 resampling of every epoch onto the
output grid + CLIPPED weighted-mean combine + AND mask combine
(``ops/resample.py``, ``ops/coadd.py``), replacing the reference's two swarp
subprocesses and tmpdir choreography (``zuds/coadd.py:25-236``).
"""
from __future__ import annotations

import os

import numpy as np

from .constants import (BKG_VAL, COADD_ZP, GROUP_PROPERTIES,
                        MASK_BIT_NODATA_ALIGN, REFERENCE_VERSION)
from .image import CalibratedImage, FITSImage
from .mask import MaskImage
from .utils import ensure_images_have_the_same_properties, mjd_from_header
from .wcs import TPVWCS, pixel_mapping

__all__ = ['Coadd', 'ReferenceImage', 'ScienceCoadd', 'coadd_grid']


def coadd_grid(images):
    """Output WCS + shape covering the union of the input footprints.

    The reference lets swarp auto-size the output projection; here an
    undistorted TAN grid at the median center and first-image pixel scale is
    built to cover every input corner.
    """
    centers = np.array([[im.ra, im.dec] for im in images])
    ra0 = np.median(centers[:, 0])
    dec0 = np.median(centers[:, 1])
    scale = images[0].pixel_scale / 3600.0
    # probe WCS to measure required extent
    probe = TPVWCS.simple(crval=(ra0, dec0), crpix=(0.0, 0.0),
                          scale_deg=scale)
    xs, ys = [], []
    for im in images:
        fp = im.footprint()
        x, y = probe.sky2pix(fp[:, 0], fp[:, 1])
        xs.extend(x)
        ys.extend(y)
    xmin, xmax = np.floor(min(xs)), np.ceil(max(xs))
    ymin, ymax = np.floor(min(ys)), np.ceil(max(ys))
    w = int(xmax - xmin + 1)
    h = int(ymax - ymin + 1)
    wcs = TPVWCS.simple(crval=(ra0, dec0), crpix=(1 - xmin, 1 - ymin),
                        scale_deg=scale)
    return wcs, (h, w)


_COADD_PIPES = {}  # (Nb, Hb, Wb, subtract_back) -> jitted program


def _coadd_fused(images, wcs, H, W, subtract_back=True):
    """Run the whole stack through ONE jitted device program
    (``make_coadd_pipeline``): per-epoch background mesh + weight + warp,
    CLIPPED combine, AND mask combine. Shapes are bucketed (output canvas
    rounded up to 128, epoch count to the next power of two) so ref
    builds across a night share compiles. Raises ValueError when an
    epoch's mapping residual exceeds the warp bucket (caller falls back
    to the per-epoch loop). Returns (coadd, weight, mask) numpy arrays
    cropped to (H, W)."""
    import jax.numpy as jnp
    from .parallel.pipeline import (PipelineConfig, make_coadd_pipeline,
                                    prepare_epoch_inputs)

    Hb = -(-H // 128) * 128
    Wb = -(-W // 128) * 128
    cfg = PipelineConfig(height=Hb, width=Wb)
    eps = [prepare_epoch_inputs(im, wcs, cfg) for im in images]
    N = len(eps)
    Nb = max(2, 1 << (N - 1).bit_length())
    key = (Nb, Hb, Wb, subtract_back)
    pipe = _COADD_PIPES.get(key)
    if pipe is None:
        pipe = make_coadd_pipeline(cfg, Nb, subtract_back=subtract_back)
        _COADD_PIPES[key] = pipe

    def stack(k, pad):
        # jnp.stack, not np.stack: 'img'/'mask' are device-resident
        # (prepare_epoch_inputs embeds+rolls on device) — np.stack would
        # pull them back over the host link
        parts = [jnp.asarray(e[k]) for e in eps]
        a = jnp.stack(parts)
        if Nb > N:
            a = jnp.concatenate(
                [a, jnp.full((Nb - N,) + a.shape[1:], pad, a.dtype)],
                axis=0)
        return a

    valid = np.zeros(Nb, 'f4')
    valid[:N] = 1.0
    out = pipe(stack('img', 0.0), stack('sat', 3e38), stack('mask', 0),
               stack('grid_u', 0.0), stack('grid_v', 0.0),
               stack('cov_bounds', 0.0), stack('scale', 1.0),
               jnp.asarray(valid))
    return (np.asarray(out['coadd'])[:H, :W],
            np.asarray(out['weight'])[:H, :W],
            np.asarray(out['mask'])[:H, :W].astype(np.int64))


def _coadd_from_images(cls, images, outfile_name, nthreads=1, addbkg=True,
                       calculate_seeing=True, tmpdir='/tmp', copy_inputs=False,
                       swarp_kws=None, scamp_kws=None, sci_swarp_kws=None,
                       mask_swarp_kws=None, solve_astrometry=False,
                       fused=True):
    """Build a coadd of ``images`` (reference: zuds/coadd.py:25-236).

    ``fused=True`` (default) routes the whole stack through one jitted
    device program; epochs whose mappings don't fit the warp bucket (or
    ``addbkg=False`` stacks of subtraction products, whose weights come
    from the propagated rms rather than a background mesh) fall back to
    the per-epoch host loop."""
    import jax.numpy as jnp
    from .ops.resample import (upsample_mapping, warp_image, warp_mask,
                               plan_warp, warp_planned)
    from .ops.coadd import clipped_coadd, combine_masks, fluxscale
    from .seeing import estimate_seeing

    images = list(images)
    properties = GROUP_PROPERTIES
    ensure_images_have_the_same_properties(images, properties)

    if solve_astrometry:
        from .scamp import calibrate_astrometry
        calibrate_astrometry(images, scamp_kws=scamp_kws, tmpdir=tmpdir,
                             inplace=True)

    wcs, (H, W) = coadd_grid(images)

    mjds = []
    for im in images:
        try:
            mjds.append(mjd_from_header(im.header))
        except KeyError:
            pass

    coadd_data = None
    if fused and addbkg:
        try:
            coadd_data, coadd_weight, mask_data = _coadd_fused(
                images, wcs, H, W, subtract_back=True)
        except ValueError as e:
            print(f'coadd: fused path unavailable ({e}); '
                  f'per-epoch fallback', flush=True)

    if coadd_data is None:
        coadd_data, coadd_weight, mask_data = _coadd_loop(
            images, wcs, H, W, addbkg)

    # no-data bit where no epoch contributed (reference: bit 16 via
    # update_from_weight_map, zuds/coadd.py:182-184)
    mask_data[coadd_weight == 0] |= (1 << MASK_BIT_NODATA_ALIGN)

    if addbkg:
        coadd_data = coadd_data + BKG_VAL

    # assemble the output object
    coadd = cls()
    header = images[0].header.copy()
    wcs.to_header(header)
    header.set('NAXIS1', W)
    header.set('NAXIS2', H)
    header.set('MAGZP', COADD_ZP, 'coadd zeropoint (FLXSCALE-normalized)')
    header.set('NCOADD', len(images), 'number of input epochs')
    if mjds:
        header.set('MJD-OBS', float(np.median(mjds)), 'median MJD of inputs')
        header.set('OBSMJD', float(np.median(mjds)))
    for prop in properties:
        val = getattr(images[0], prop, None)
        if val is not None:
            setattr(coadd, prop, val)
    coadd.header = header
    coadd.data = coadd_data.astype('f4')
    coadd.basename = os.path.basename(outfile_name)
    coadd.input_images = images

    coadd.map_to_local_file(outfile_name)

    mask = MaskImage.from_parent(coadd, data=mask_data.astype(np.int32))
    mask.basename = coadd.basename.replace('.fits', '.mask.fits')
    mask.refresh_bit_mask_entries_in_header()
    mask.map_to_local_file(os.path.join(os.path.dirname(outfile_name),
                                        mask.basename))
    coadd.mask_image = mask

    coadd._set_product('_weightimg', coadd_weight)

    coadd.save()
    mask.save()

    if calculate_seeing:
        estimate_seeing(coadd)
    coadd.save()

    # DB association when a database is bound
    from .core import DBSession
    sess = DBSession()
    if sess.conn is not None:
        from .core import record_from_image
        from .joins import CoaddImage
        rec = record_from_image(coadd, getattr(cls, '__ztf_type__', 'coadd'))
        sess.add(rec)
        sess.commit()
        coadd.id = rec.id
        for im in images:
            if getattr(im, 'id', None) is not None:
                sess.add(CoaddImage(coadd_id=rec.id,
                                    calibratableimage_id=im.id))
        sess.commit()

    return coadd


def _coadd_loop(images, wcs, H, W, addbkg):
    """Per-epoch host-driven warp + combine (the pre-fusion path; kept
    for exotic mappings and addbkg=False subtraction stacks)."""
    import jax.numpy as jnp
    from .ops.resample import (upsample_mapping, warp_image, warp_mask,
                               plan_warp, warp_planned)
    from .ops.coadd import clipped_coadd, combine_masks, fluxscale
    from .wcs import pixel_mapping

    warped, weights, masks, covs, scales = [], [], [], [], []
    for im in images:
        grid = pixel_mapping(im.wcs, wcs, (H, W))
        u, v = upsample_mapping(jnp.asarray(grid.u), jnp.asarray(grid.v),
                                grid.shape, grid.step)
        # Science coadds combine per-epoch background-subtracted pixels
        # (swarp SUBTRACT_BACK Y, reference makecoadd/default.swarp:77);
        # epoch-to-epoch sky offsets would otherwise be FLXSCALE-amplified
        # and bias the CLIPPED combine. The addbkg=False path (multi-epoch
        # subtraction stacking) feeds already-background-free frames.
        src = im.background_subtracted_image if addbkg else im
        data = jnp.asarray(
            np.ascontiguousarray(src.data).astype(np.float32))
        wdat = jnp.asarray(
            np.ascontiguousarray(im.weight_image.data).astype(np.float32))
        if im.mask_image is not None:
            m = jnp.asarray(np.ascontiguousarray(im.mask_image.data)
                            .astype(np.uint32))
        else:
            m = jnp.zeros(data.shape, dtype=jnp.uint32)
        # host-planned fast warp (integer pre-shift + small residual
        # window); gather fallback for exotic mappings
        plan = plan_warp(grid, (H, W), tuple(data.shape))
        if plan is not None:
            img_w, m_w, cov = warp_planned(data, m, u, v, plan, (H, W))
            wgt_w, _, _ = warp_planned(wdat, jnp.zeros_like(m), u, v,
                                       plan, (H, W))
        else:
            img_w, cov = warp_image(data, u, v)
            wgt_w, _ = warp_image(wdat, u, v)
            m_w = warp_mask(m, u, v)
        wgt_w = jnp.maximum(wgt_w, 0.0) * cov
        masks.append(m_w.astype(jnp.uint16))
        warped.append(img_w)
        weights.append(wgt_w)
        covs.append(cov)
        zp = im.header.get('MAGZP')
        scales.append(float(fluxscale(zp)) if zp is not None else 1.0)

    stack = jnp.stack(warped)
    wstack = jnp.stack(weights)
    out = clipped_coadd(stack, wstack, jnp.asarray(scales, jnp.float32))
    mask_out = combine_masks(jnp.stack(masks), jnp.stack(covs), mode='and')

    return (np.array(out['coadd']), np.array(out['weight']),
            np.array(mask_out).astype(np.int64))


class Coadd(CalibratedImage):
    """Combination of multiple epochs of one quadrant."""

    __ztf_type__ = 'coadd'

    input_images = None

    from_images = classmethod(_coadd_from_images)

    @property
    def mjd(self):
        return mjd_from_header(self.header)

    @property
    def min_mjd(self):
        return min(mjd_from_header(i.header) for i in self.input_images)

    @property
    def max_mjd(self):
        return max(mjd_from_header(i.header) for i in self.input_images)


class ReferenceImage(Coadd):
    """Template coadd used as the subtraction reference
    (reference: zuds/coadd.py:287-299)."""

    __ztf_type__ = 'ref'

    version = REFERENCE_VERSION


class ScienceCoadd(Coadd):
    """Time-binned science stack (reference: zuds/coadd.py:302-316)."""

    __ztf_type__ = 'scicoadd'

    binleft = None
    binright = None
