"""Subtraction pipeline step (reference: zuds/subtraction.py).

``Subtraction.from_images`` keeps the reference's transaction shape
(align ref -> combine masks -> PSF-match & subtract -> flag nodata ->
inherit headers -> persist) with the hotpants subprocess
(``zuds/subtraction.py:57-226``) replaced by the device A&L kernel fit
(``ops/subtract.py``) — and adds the ZOGY path (``method='zogy'``) the
rebuild spec requires.
"""
from __future__ import annotations

import os

import numpy as np

from .constants import (BKG_VAL, BIG_RMS, HOTPANTS_SATLEV,
                        KERNEL_RADIUS_SEEING, MASK_BIT_NODATA_SUB,
                        SUB_NODATA_SENTINEL, BAD_SUM)
from .image import CalibratedImage, CalibratableImage, FITSImage
from .mask import MaskImage

__all__ = ['sub_name', 'Subtraction', 'SingleEpochSubtraction',
           'MultiEpochSubtraction', 'overlapping_subtractions']


def sub_name(frame, template):
    """sub.<frame>_<template>.fits naming (reference:
    zuds/subtraction.py:25-37)."""
    refp = os.path.basename(f'{template}')[:-5]
    newp = os.path.basename(f'{frame}')[:-5]
    outdir = os.path.dirname(f'{frame}')
    return os.path.join(outdir, f'sub.{newp}_{refp}.fits')


def _select_stamps(sci, smax=128):
    """Star stamp centers for the kernel fit, from the science catalog."""
    from .seeing import select_stars
    cat = sci.catalog
    stars = select_stars(cat, min_snr=10.0)
    data = stars if len(stars) else (cat.data if hasattr(cat, 'data')
                                     else cat)
    sat = HOTPANTS_SATLEV
    ok = data['FLUX_MAX'] < sat
    data = data[ok]
    order = np.argsort(data['FLUX_APER'])[::-1]
    data = data[order[:smax]]
    xs = np.zeros(smax, dtype='f4')
    ys = np.zeros(smax, dtype='f4')
    valid = np.zeros(smax, dtype=bool)
    nsel = len(data)
    xs[:nsel] = data['X_IMAGE'] - 1.0
    ys[:nsel] = data['Y_IMAGE'] - 1.0
    valid[:nsel] = True
    return xs, ys, valid


class Subtraction:
    """Mixin: shared subtraction construction logic."""

    reference_image = None
    target_image = None

    @property
    def mjd(self):
        return self.target_image.mjd

    @classmethod
    def from_images(cls, sci, ref, data_product=False, tmpdir='/tmp',
                    method='hotpants', nreg_side=3, spatial_order=None,
                    smax=128, **kwargs):
        """Subtract ``ref`` from ``sci`` (reference:
        zuds/subtraction.py:57-226).

        method='hotpants': A&L spatially-varying PSF-matching kernel
        (3x3 regions, order-4 spatial variation by default).
        method='zogy': proper subtraction in Fourier space; also returns
        the S_corr score image as the ``scorr_image`` attribute.
        """
        import jax.numpy as jnp
        from .constants import KERNEL_SPATIAL_ORDER
        from .seeing import estimate_seeing
        from .ops.subtract import KernelBasis, fit_kernel, subtract_frames

        if spatial_order is None:
            spatial_order = KERNEL_SPATIAL_ORDER

        # --- geometry: bring the reference onto the science grid ------------
        remapped_ref = ref.aligned_to(sci)
        remapped_refmask = ref.mask_image.aligned_to(sci) \
            if ref.mask_image is not None else None

        # --- mask union (reference: zuds/subtraction.py:126-142) ------------
        H, W = sci.shape
        submask_data = np.zeros((H, W), dtype=np.uint32)
        if sci.mask_image is not None:
            submask_data |= np.asarray(sci.mask_image.data).astype(np.uint32)
        if remapped_refmask is not None:
            submask_data |= np.asarray(remapped_refmask.data) \
                .astype(np.uint32)
        bad = (submask_data & BAD_SUM) > 0

        # --- science background handling (hotpants.py:27-31) -----------------
        if 'SEEING' not in sci.header:
            estimate_seeing(sci)
        seeing = float(sci.header['SEEING'])
        scimbkg = np.ascontiguousarray(
            sci.background_subtracted_image.data).astype(np.float32) + BKG_VAL
        refdata = np.ascontiguousarray(
            remapped_ref.data).astype(np.float32)

        sci_rms = np.ascontiguousarray(sci.rms_image.data).astype(np.float32)
        ref_rms_obj = getattr(ref, 'rms_image', None)
        if ref_rms_obj is not None:
            ref_rms_aligned = ref_rms_obj.aligned_to(sci)
            ref_rms = np.ascontiguousarray(ref_rms_aligned.data) \
                .astype(np.float32)
        else:
            ref_rms = np.zeros_like(sci_rms)

        outfile_name = sub_name(
            sci.local_path if sci.ismapped else sci.basename,
            ref.local_path if ref.ismapped else ref.basename)

        # conditioning guard: the per-region fit has Nb*Nm+1 unknowns; with
        # too few star stamps per region the ridge solve degrades silently
        # (hotpants runs ~100 substamps/region at production scale). Reduce
        # the spatial order, then the region grid, until determined.
        from .constants import KERNEL_GAUSS_DEGREES
        from .ops.subtract import spatial_terms
        _, _, valid_all = _select_stamps(sci, smax=smax)
        nstamps = max(int(valid_all.sum()), 1)
        nbasis = sum((d + 1) * (d + 2) // 2 for d in KERNEL_GAUSS_DEGREES)
        while nreg_side > 1 or spatial_order > 0:
            unknowns = nbasis * len(spatial_terms(spatial_order)) + 1
            if nstamps / (nreg_side ** 2) >= 0.1 * unknowns:
                break
            if spatial_order > 0:
                spatial_order -= 1
            else:
                nreg_side -= 1

        if method == 'zogy':
            from .ops.zogy import zogy_subtract, estimate_psf_from_stars
            xs, ys, valid = _select_stamps(sci, smax=64)
            psf_new = estimate_psf_from_stars(
                jnp.asarray(scimbkg - BKG_VAL), jnp.asarray(xs),
                jnp.asarray(ys), jnp.asarray(valid))
            # science-frame star positions are intentionally reused on the
            # remapped reference: refdata is already aligned into the
            # science grid, so ref-catalog coordinates (unaligned frame)
            # would be the wrong frame here
            psf_ref = estimate_psf_from_stars(
                jnp.asarray(refdata), jnp.asarray(xs),
                jnp.asarray(ys), jnp.asarray(valid))
            sn = float(np.median(sci_rms[~bad])) if (~bad).any() else 1.0
            sr = float(np.median(ref_rms[~bad])) if (~bad).any() else 1.0
            zout = zogy_subtract(jnp.asarray(scimbkg - BKG_VAL),
                                 jnp.asarray(refdata),
                                 psf_new, psf_ref, sn, max(sr, 1e-3))
            diff = np.array(zout['d'])
            diff[bad] = SUB_NODATA_SENTINEL
            rms_out = np.sqrt(sci_rms ** 2 + ref_rms ** 2)
            rms_out[bad] = BIG_RMS
            scorr = np.array(zout['s_corr'])
        else:
            # --- A&L kernel fit over star stamps -----------------------------
            xs, ys, valid = _select_stamps(sci, smax=smax)
            ksize = int(2 * round(KERNEL_RADIUS_SEEING * seeing / 2) + 1)
            ksize = max(9, min(ksize, 31))
            stamp = int(2 * round(6 * seeing / 2) + 1 + ksize)
            stamp = max(stamp, ksize + 10)
            stamp = stamp + (1 - stamp % 2)
            basis = KernelBasis(ksize, seeing_sigma=seeing / 2.355)
            ivar = 1.0 / np.maximum(sci_rms ** 2 + ref_rms ** 2, 1e-6)
            ivar[bad] = 0.0
            fit = fit_kernel(jnp.asarray(refdata), jnp.asarray(scimbkg),
                             jnp.asarray(ivar), jnp.asarray(xs),
                             jnp.asarray(ys), jnp.asarray(valid),
                             basis.gx, basis.gy, basis.sums,
                             jnp.asarray(basis.b0_2d), stamp=stamp,
                             order=spatial_order, nreg=nreg_side)
            diff_j, rms_j = subtract_frames(
                jnp.asarray(scimbkg), jnp.asarray(refdata),
                jnp.asarray(sci_rms), jnp.asarray(ref_rms),
                jnp.asarray(bad), fit, basis, order=spatial_order,
                nreg=nreg_side)
            diff = np.array(diff_j)
            rms_out = np.array(rms_j)
            scorr = None

        sub = cls.assemble(sci, ref, diff, rms_out, submask_data,
                           method=method, spatial_order=spatial_order,
                           nreg_side=nreg_side, scorr=scorr,
                           data_product=data_product,
                           outfile_name=outfile_name)
        return sub

    @classmethod
    def assemble(cls, sci, ref, diff, rms_out, submask_data,
                 method='hotpants', spatial_order=None, nreg_side=3,
                 scorr=None, data_product=False, outfile_name=None):
        """Build the subtraction product object from computed arrays.

        Shared by the per-pair path (``from_images``) and the batched night
        driver (``scripts/donight.py``), which computes diff/rms/submask in
        the fused device pipeline and assembles identical products here
        (header inheritance per zuds/subtraction.py:208-215, nodata bit 17
        per zuds/subtraction.py:167-177).
        """
        if outfile_name is None:
            outfile_name = sub_name(
                sci.local_path if sci.ismapped else sci.basename,
                ref.local_path if ref.ismapped else ref.basename)
        submask_data = np.asarray(submask_data).astype(np.uint32).copy()
        # --- nodata bit 17 (reference: zuds/subtraction.py:167-177) ----------
        submask_data[diff == SUB_NODATA_SENTINEL] |= np.uint32(
            1 << MASK_BIT_NODATA_SUB)

        sub = cls()
        header = sci.header.copy()
        # inherit photometric calibration from the science frame
        # (reference: zuds/subtraction.py:208-215)
        for kw in ('SEEING', 'MAGZP', 'APCOR1', 'APCOR2', 'APCOR3', 'APCOR4',
                   'APCOR5', 'APCOR6', 'APCORUN1', 'APCORUN2', 'APCORUN3',
                   'APCORUN4', 'APCORUN5', 'APCORUN6'):
            if kw in sci.header:
                header.set(kw, sci.header[kw])
        header.set('SUBMETH', method, 'subtraction engine')
        header.set('SUBKO', spatial_order if spatial_order is not None
                   else -1, 'kernel spatial order used')
        header.set('SUBNRX', nreg_side, 'kernel region grid used')
        sub.header = header
        sub.data = diff.astype('f4')
        sub.basename = os.path.basename(outfile_name)
        sub.reference_image = ref
        sub.target_image = sci
        for prop in ('field', 'ccdid', 'qid', 'fid'):
            setattr(sub, prop, getattr(sci, prop, None))
        sub._wcs = sci.wcs
        if hasattr(sci, 'ra'):
            for attr in ('ra', 'dec', 'ra1', 'dec1', 'ra2', 'dec2', 'ra3',
                         'dec3', 'ra4', 'dec4'):
                if hasattr(sci, attr):
                    setattr(sub, attr, getattr(sci, attr))

        mask = MaskImage.from_parent(sub, data=submask_data.astype(np.int32))
        mask.basename = sub.basename.replace('.fits', '.mask.fits')
        mask.refresh_bit_mask_entries_in_header()
        sub.mask_image = mask

        if sci.ismapped:
            sub.map_to_local_file(outfile_name)
            mask.map_to_local_file(os.path.join(
                os.path.dirname(outfile_name), mask.basename))
            sub.save()
            mask.save()
        sub._set_product('_rmsimg', rms_out)
        if scorr is not None:
            s = FITSImage()
            s.data = scorr.astype('f4')
            s.header = header.copy()
            s.basename = sub.basename.replace('.fits', '.scorr.fits')
            sub.scorr_image = s

        if data_product:
            from .archive import archive
            archive(sub)

        return sub

    # -- deferred-frame assembly (fused-pipeline path) ----------------------
    # The batched night driver's catalogs/filters read only fixed-size
    # detection rows computed on device; the 3 full frames (~110 MB/frame
    # f32+f32+i32) are fetched from the device — and the product FITS
    # written — only when something actually touches pixels (thumbnails,
    # ML triplets, archiving) — not ~150 MB of product files per quadrant
    # regardless.

    @classmethod
    def assemble_deferred(cls, sci, ref, frames_thunk,
                          method='hotpants-fused', spatial_order=None,
                          nreg_side=3, outfile_name=None):
        """Like ``assemble`` but with the pixel frames left on device.

        ``frames_thunk``: zero-arg callable returning ``(diff, rms,
        submask)`` as host arrays; called at most once, on first pixel
        access. The fused pipeline already applied the nodata bit 17
        semantics in-program (reference zuds/subtraction.py:167-177), so
        no mask post-processing is needed here.
        """
        if outfile_name is None:
            outfile_name = sub_name(
                sci.local_path if sci.ismapped else sci.basename,
                ref.local_path if ref.ismapped else ref.basename)
        sub = cls()
        header = sci.header.copy()
        for kw in ('SEEING', 'MAGZP', 'APCOR1', 'APCOR2', 'APCOR3',
                   'APCOR4', 'APCOR5', 'APCOR6', 'APCORUN1', 'APCORUN2',
                   'APCORUN3', 'APCORUN4', 'APCORUN5', 'APCORUN6'):
            if kw in sci.header:
                header.set(kw, sci.header[kw])
        header.set('SUBMETH', method, 'subtraction engine')
        header.set('SUBKO', spatial_order if spatial_order is not None
                   else -1, 'kernel spatial order used')
        header.set('SUBNRX', nreg_side, 'kernel region grid used')
        sub.header = header
        sub.basename = os.path.basename(outfile_name)
        sub.reference_image = ref
        sub.target_image = sci
        for prop in ('field', 'ccdid', 'qid', 'fid'):
            setattr(sub, prop, getattr(sci, prop, None))
        sub._wcs = sci.wcs
        if hasattr(sci, 'ra'):
            for attr in ('ra', 'dec', 'ra1', 'dec1', 'ra2', 'dec2', 'ra3',
                         'dec3', 'ra4', 'dec4'):
                if hasattr(sci, attr):
                    setattr(sub, attr, getattr(sci, attr))

        mask = MaskImage.from_parent(sub)
        mask.basename = sub.basename.replace('.fits', '.mask.fits')
        sub.mask_image = mask
        sub._frames_thunk = frames_thunk
        # mapping reserves the product paths now (so catalogs save beside
        # the sub); the pixel files are written at materialization
        if sci.ismapped:
            sub.map_to_local_file(outfile_name)
            mask.map_to_local_file(os.path.join(
                os.path.dirname(outfile_name), mask.basename))
        # route any pixel access on the mask through materialization
        mask.load = sub._materialize_frames
        return sub

    def _materialize_frames(self):
        """Fetch diff/rms/submask from the device (once) and finish the
        product assembly ``assemble`` would have done eagerly."""
        thunk = getattr(self, '_frames_thunk', None)
        if thunk is None:
            return
        self._frames_thunk = None
        diff, rms_out, submask = thunk()
        diff = np.asarray(diff).astype('f4')
        rms_out = np.asarray(rms_out).astype('f4')
        submask = np.asarray(submask).astype(np.int32)
        self._data = diff
        mask = self.mask_image
        mask._data = submask
        mask.refresh_bit_mask_entries_in_header()
        # in-memory derived products: a subtraction's background is
        # identically zero by construction
        for attr, arr in (('_rmsimg', rms_out),
                          ('_bkgimg', np.zeros_like(diff)),
                          ('_bkgsubimg', diff)):
            prod = FITSImage()
            prod.data = arr
            prod.header = self.header.copy()
            prod.parent_image = self
            if self.basename:
                prod.basename = self.basename.replace(
                    '.fits', self._product_suffixes.get(attr,
                                                        f'{attr}.fits'))
            setattr(self, attr, prod)
        if self.ismapped:
            self.save()
            mask.save()
            rms_prod = self._rmsimg
            rms_prod.map_to_local_file(os.path.join(
                os.path.dirname(self.local_path), rms_prod.basename))
            rms_prod.save()

    def load(self):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
            return
        super().load()

    @property
    def data(self):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
        try:
            return self._data
        except AttributeError:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    def _frame_product(self, attr):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
        try:
            return getattr(self, attr)
        except AttributeError:
            self._run_background()
        return getattr(self, attr)

    @property
    def rms_image(self):
        return self._frame_product('_rmsimg')

    @property
    def background_image(self):
        return self._frame_product('_bkgimg')

    @property
    def background_subtracted_image(self):
        return self._frame_product('_bkgsubimg')


class SingleEpochSubtraction(Subtraction, CalibratedImage):
    """sci - ref for one epoch (reference: zuds/subtraction.py:229-240)."""

    __ztf_type__ = 'sesub'


def overlapping_subtractions(sci, ref):
    """Single-epoch subtractions whose targets feed coadd ``sci``
    (reference: zuds/subtraction.py:243-258). DB-backed."""
    from .core import DBSession, ZTFFile
    from .joins import CoaddImage

    sess = DBSession()
    if sess.conn is None:
        raise RuntimeError('overlapping_subtractions needs a bound database')
    rows = sess.execute(
        'SELECT z.id FROM ztffiles z '
        'JOIN ztffiles t ON z.target_id = t.id '
        'JOIN coadd_images c ON c.calibratableimage_id = t.id '
        'WHERE c.coadd_id = ? AND z.reference_id = ? AND z.type = ?',
        (sci.id, ref.id, 'sesub')).fetchall()
    return [sess.get(ZTFFile, r[0]) for r in rows]


class MultiEpochSubtraction(Subtraction, CalibratableImage):
    """Coadd of overlapping single-epoch subtractions
    (reference: zuds/subtraction.py:283-319)."""

    __ztf_type__ = 'mesub'

    input_images = None

    @classmethod
    def from_images(cls, sci, ref, data_product=False, tmpdir='/tmp',
                    force_map_subs=True, input_subtractions=None, **kwargs):
        from .coadd import ScienceCoadd, _coadd_from_images

        if not isinstance(sci, ScienceCoadd):
            raise TypeError(f'Input science image "{sci.basename}" must be '
                            f'an instance of ScienceCoadd, got {type(sci)}.')

        if input_subtractions is not None:
            images = list(input_subtractions)
        else:
            images = overlapping_subtractions(sci, ref)

        if len(images) != len(sci.input_images):
            raise ValueError(
                'Number of single-epoch subtractions != number of stack '
                f'inputs ({len(images)} vs {len(sci.input_images)})')

        outfile_name = sub_name(
            sci.local_path if sci.ismapped else sci.basename,
            ref.local_path if ref.ismapped else ref.basename)

        coadd = _coadd_from_images(cls, images, outfile_name,
                                   addbkg=False, calculate_seeing=False)
        coadd.reference_image = ref
        coadd.target_image = sci
        coadd.header.set('SEEING', sci.header['SEEING'])
        coadd.save()
        return coadd
