"""The exact rect's tail in the PyTorch port: the cv2 centres
(ops/cv2_centers.py, kernel csrc/cv2_centers.cu), the hull-edge finish and
the rect select (ops/rect.py, kernels csrc/rect.cu).

- On CPU tensors each wrapper returns its plain version's outputs; on a
  device that is neither the CPU nor CUDA it raises.
- The plain versions against ``ysmr_tpu`` on XLA:CPU, on the fuzz
  generators of tests/test_cv2_centers.py: cv2 centres and ``ok`` bit for
  bit (``cv2_centers_standalone``); the edge finish bit for bit
  (``_edge_vector_finish``, twice); the rect W/H and angle bit for bit and
  its centre within 1e-4 px (``min_area_rect``'s jitted exact branch,
  ``_min_area_rect_exact``: XLA:CPU may contract the double-single centre
  into fmas, see tests/test_torch_labeling.py).
- Each kernel's design as a numpy float32 emulation (one rounding per
  operation, the kernel's order: the warp per component as 32 lanes, the
  ballot compaction, the rank count for the 8 candidates, the butterfly
  minimum of the double-single areas), bit-equal to the plain version on
  ~1200 fuzz components plus the edge cases: no valid row, a single
  point, lines, more than 32 strict corners, more than 8 in-band
  candidates, an edge vector past the inverse-sqrt table, equal
  surrogate areas and equal angles.
- fdlibm's ``atan2f`` in the kernel's scalar C order, emulated in numpy
  float32, against the plain ``_atan2_f32`` and ``jnp.arctan2`` over
  every folded integer vector with 0 <= dy <= 256, 1 <= dx <= 256.
- ``cuda``-marked twins hold each kernel bit-equal to its plain version on
  the card (they skip here).

Tolerance: none, except the JAX rect centre above. ``ok`` is compared
everywhere, the centres where ``ok`` is True (the pipeline reads nothing
else).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rect_tail_cases as cases  # noqa: E402
from test_cv2_centers import random_blob, thin_rod  # noqa: E402
from ysmr_tpu.ops import cv2_centers as jcc  # noqa: E402
from ysmr_tpu.ops import labeling as jlb  # noqa: E402
from ysmr_tpu_torch.ops import cv2_centers as tcc  # noqa: E402
from ysmr_tpu_torch.ops import labeling as lb  # noqa: E402
from ysmr_tpu_torch.ops import rect  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
MAX_EDGE_W = 256
BIG = cases.BIG


# ---------------------------------------------------------------- inputs

def edge_case_blobs():
    """(blobs, R): the shared edge cases of ``rect_tail_cases``, then 8
    seeded random blobs."""
    rng = np.random.default_rng(11)
    blobs = cases.edge_case_blobs()
    blobs += [random_blob(rng, max_side=40) for _ in range(8)]
    return blobs, cases.EDGE_CASE_ROWS


def fuzz_blobs(n, seed):
    rng = np.random.default_rng(seed)
    return [random_blob(rng) if i % 2 else thin_rod(rng) for i in range(n)]


def cv2_inputs(blobs, r):
    """The cv2-centre kernel's inputs as the pipeline gives them: tables,
    the corner masks of the plain hull, the inverse-sqrt table."""
    rmin, rmax, rvalid, min_y = (torch.from_numpy(a) for a in
                                 cases.row_tables(blobs, r))
    abs_y = (min_y[:, None] + torch.arange(r, dtype=torch.int32)
             ).contiguous()
    *_, cl, cr = lb._hull_edge_data(rmin, rmax, rvalid, abs_y)
    isq = tcc.inv_sqrt_table(MAX_EDGE_W, r)
    return rmin, rmax, rvalid, min_y, cl, cr, isq


def rect_inputs(blobs, r):
    """The edge-finish and rect-select inputs of the blobs' tables: the
    hull's chain outputs, the sweep's extents and directions, the edge
    angles and validity."""
    rmin, rmax, rvalid, min_y = (torch.from_numpy(a) for a in
                                 cases.row_tables(blobs, r))
    tabs = lb._stats_tail_from_tables(rmin, rmax, rvalid, min_y, max_bh=r)
    abs_y = (min_y[:, None] + torch.arange(r, dtype=torch.int32)
             ).contiguous()
    chains = lb.hull_edge_vectors_plain(rmin, rmax, rvalid, abs_y)[:6]
    d = rmin.shape[0]
    one = torch.ones((d, 1))
    dx = torch.cat([tabs['edge_dx'], one], 1).contiguous()
    dy = torch.cat([tabs['edge_dy'], one * 0.0], 1).contiguous()
    ext = lb.sweep_extents_plain(tabs['points'], tabs['points_valid'], dx, dy)
    return chains, (*ext, dx, dy, tabs['edge_angles'], tabs['edge_valid'])


# ------------------------------------------------- fdlibm in the C order

def _f32s(*hexes):
    """float32 array of C hex-float literals (the kernel's constants)."""
    return np.array([float.fromhex(h) for h in hexes], F32)


_HI = _f32s('0x1.dac670p-2', '0x1.921fb4p-1', '0x1.f730bcp-1',
            '0x1.921fb4p+0')
_LO = _f32s('0x1.586ed2p-28', '0x1.4442d0p-25', '0x1.281f68p-25',
            '0x1.4442d0p-24')
_T = _f32s('0x1.555556p-2', '-0x1.99999ap-3', '0x1.24924ap-3',
           '-0x1.c71c70p-4', '0x1.745cdcp-4', '-0x1.3b0f2ap-4',
           '0x1.10d66ap-4', '-0x1.dde2d6p-5', '0x1.97b4b2p-5',
           '-0x1.2b4442p-5', '0x1.0ad3aep-6')
_PI_O2, _PI_LO = _f32s('0x1.921fb6p+0', '-0x1.777a5cp-24')
_RAD_TO_DEG, = _f32s('0x1.ca5dc2p+5')


def _atanf_c(x):
    """csrc/rect.cu's atanf_fdlibm on a float32 array x >= 0: each element
    takes the branch its bits select, one float32 rounding an operation."""
    one, two, c15 = F32(1), F32(2), F32(1.5)
    x = np.asarray(x, F32)
    ix = x.view(np.int32)
    idx = np.select([ix >= 0x401c0000, ix >= 0x3f980000, ix >= 0x3f300000,
                     ix >= 0x3ee00000], [3, 2, 1, 0], -1)
    xr = x.copy()
    for i, red in ((3, lambda v: -one / v),
                   (2, lambda v: (v - c15) / (one + c15 * v)),
                   (1, lambda v: (v - one) / (v + one)),
                   (0, lambda v: (v * two - one) / (two + v))):
        xr[idx == i] = red(x[idx == i])
    z = xr * xr
    w = z * z
    t = _T
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (
        t[8] + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    s = s1 + s2
    ii = np.maximum(idx, 0)
    out = np.where(idx < 0, xr - xr * s, _HI[ii] - ((xr * s - _LO[ii]) - xr))
    out = np.where(ix < 0x31000000, x, out)
    return np.where(ix >= 0x4c000000, _HI[3] + _LO[3], out).astype(F32)


def atan2f_c(y, x):
    """csrc/rect.cu's atan2f_fdlibm, elementwise on float32 arrays (finite
    y >= 0, x > 0), in its scalar order: y == 0, then x == 1, then the
    exponent gap k > 60."""
    y = np.asarray(y, F32)
    x = np.asarray(x, F32)
    out = np.empty_like(y)
    k = (y.view(np.int32).astype(np.int64) -
         x.view(np.int32).astype(np.int64)) >> 23
    quot = np.abs(y / x)
    first = y == 0
    unit = ~first & (x == 1)
    far = ~first & ~unit & (k > 60)
    rest = ~first & ~unit & ~far
    out[first] = y[first]
    out[unit] = _atanf_c(y[unit])
    out[far] = _PI_O2 + F32(0.5) * _PI_LO
    out[rest] = _atanf_c(quot[rest])
    return out


def test_atan2_c_order_matches_plain_and_xla_on_every_folded_vector():
    dy, dx = np.meshgrid(np.arange(0, 257, dtype=F32),
                         np.arange(1, 257, dtype=F32), indexing='ij')
    dy, dx = dy.ravel(), dx.ravel()
    got = atan2f_c(dy, dx)
    plain = lb._atan2_f32(torch.from_numpy(dy), torch.from_numpy(dx))
    np.testing.assert_array_equal(got.view(np.int32),
                                  plain.numpy().view(np.int32))
    xla = np.asarray(jnp.arctan2(jnp.asarray(dy), jnp.asarray(dx)))
    np.testing.assert_array_equal(got.view(np.int32), xla.view(np.int32))
    # every reduction branch is taken
    assert len(np.unique(np.searchsorted([7 / 16, 11 / 16, 19 / 16, 39 / 16],
                                         dy / dx))) == 5


# --------------------------------------------------- emulated designs

def edge_finish_emulated(dxl, dyl, el, dxr, dyr, er):
    """csrc/rect.cu's edge-finish kernel: one thread per (component, chain
    slot); returns (dx, dy, angles, valid) (D, 2 (R - 1))."""
    r = dxl.shape[1]
    m = r - 1
    dx = np.concatenate([dxl[:, :m], dxr[:, :m]], 1).astype(F32)
    dy = np.concatenate([dyl[:, :m], dyr[:, :m]], 1).astype(F32)
    keep = np.concatenate([el[:, :m], er[:, :m]], 1)
    slot = np.tile(np.arange(m), 2)[None, :]
    neg = (dy < 0) | ((dy == 0) & (dx < 0))
    dx, dy = np.where(neg, -dx, dx), np.where(neg, -dy, dy)
    rot = (dx <= 0) & (dy > 0)
    dx, dy = np.where(rot, dy, dx), np.where(rot, -dx, dy)
    dx = np.where((dx == 0) & (dy == 0), F32(1), dx)
    ang = np.zeros_like(dx)
    ang[keep] = atan2f_c(dy[keep], dx[keep])
    return (np.where(keep, dx, F32(1)), np.where(keep, dy, F32(0)), ang,
            keep | (slot == 0))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick(a, b):
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    ca = F32(4097) * a
    ah = ca - (ca - a)
    al = a - ah
    cb = F32(4097) * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _ds_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    return _quick(s, e + (xl + yl))


def _ds_area(mnu, mxu, mnv, mxv, dx, dy, valid):
    with np.errstate(over='ignore'):
        du = np.maximum(mxu - mnu, F32(0))
        dv = np.maximum(mxv - mnv, F32(0))
    l2 = dx * dx + dy * dy
    ah, al = _two_prod(du, dv)
    q0 = ah / l2
    r0h, r0l = _two_prod(q0, l2)
    rh, rl = _ds_add(ah, al, -r0h, -r0l)
    h, lo = _quick(q0, (rh + rl) / l2)
    return (np.where(valid, h, F32(3e38)), np.where(valid, lo, F32(0)), du,
            dv, l2)


def _less(bh, bl, ah, al):
    return (bh < ah) | ((bh == ah) & (bl < al))


def halving_tree_min(h, lo):
    """The plain version's pairwise-halving double-single minimum."""
    h, lo = h.copy(), lo.copy()
    n = h.shape[1]
    while n > 1:
        half = n // 2
        if n % 2:
            lt = _less(h[:, n - 1], lo[:, n - 1], h[:, 0], lo[:, 0])
            h[:, 0] = np.where(lt, h[:, n - 1], h[:, 0])
            lo[:, 0] = np.where(lt, lo[:, n - 1], lo[:, 0])
        lt = _less(h[:, half:2 * half], lo[:, half:2 * half], h[:, :half],
                   lo[:, :half])
        h = np.where(lt, h[:, half:2 * half], h[:, :half])
        lo = np.where(lt, lo[:, half:2 * half], lo[:, :half])
        n = half
    return h[:, 0], lo[:, 0]


def rect_select_emulated(mnu, mxu, mnv, mxv, edx, edy, eang, evalid):
    """csrc/rect.cu's rect-select kernel: a warp per component, lane l over
    candidates l, l + 32, ...; returns the outputs and the warp minimum
    (h, l) of the areas."""
    d, k = mnu.shape
    eang = np.concatenate([eang, np.zeros((d, 1), F32)], 1)
    evalid = np.concatenate([evalid, np.ones((d, 1), bool)], 1)
    ah, al, du, dv, l2 = _ds_area(mnu, mxu, mnv, mxv, edx, edy, evalid)
    # pass 1: each lane's least area in its order, then the butterfly
    lanes = 32
    mh = np.full((d, lanes), np.inf, F32)
    ml = np.zeros((d, lanes), F32)
    have = np.zeros((d, lanes), bool)
    for kk in range(k):
        ln = kk % lanes
        take = ~have[:, ln] | _less(ah[:, kk], al[:, kk], mh[:, ln],
                                    ml[:, ln])
        mh[:, ln] = np.where(take, ah[:, kk], mh[:, ln])
        ml[:, ln] = np.where(take, al[:, kk], ml[:, ln])
        have[:, ln] = True
    for off in (16, 8, 4, 2, 1):
        src = np.arange(lanes) ^ off
        oh, ol, ov = mh[:, src], ml[:, src], have[:, src]
        take = ov & (~have | _less(oh, ol, mh, ml))
        mh, ml = np.where(take, oh, mh), np.where(take, ol, ml)
        have = have | ov
    m_h, m_l = mh[:, 0], ml[:, 0]
    # pass 2: the tie band and each lane's first largest angle
    band = m_h * F32(1e-9) + F32(1e-9)
    diff, _ = _ds_add(ah, al, -m_h[:, None], -m_l[:, None])
    val = np.where(evalid & (diff <= band[:, None]), eang, F32(-1))
    best = np.full((d, lanes), -np.inf, F32)
    bk = np.full((d, lanes), k)
    for kk in range(k):
        ln = kk % lanes
        take = val[:, kk] > best[:, ln]
        best[:, ln] = np.where(take, val[:, kk], best[:, ln])
        bk[:, ln] = np.where(take, kk, bk[:, ln])
    for off in (16, 8, 4, 2, 1):
        src = np.arange(lanes) ^ off
        ob, ok = best[:, src], bk[:, src]
        take = (ob > best) | ((ob == best) & (ok < bk))
        best, bk = np.where(take, ob, best), np.where(take, ok, bk)
    rows = np.arange(d)
    b = bk[:, 0]
    bdx, bdy, bl2 = edx[rows, b], edy[rows, b], l2[rows, b]
    bl = np.sqrt(bl2.astype(np.float64)).astype(F32)
    cu2 = mnu[rows, b] + mxu[rows, b]
    cv2_ = mnv[rows, b] + mxv[rows, b]
    t1, t2 = _two_prod(cu2, bdx), _two_prod(cv2_, bdy)
    nxh, nxl = _ds_add(*t1, -t2[0], -t2[1])
    nyh, nyl = _ds_add(*_two_prod(cu2, bdy), *_two_prod(cv2_, bdx))
    inv = F32(1) / (F32(2) * bl2)
    # one float32 fma: the product and the sum are exact in the 64-bit
    # mantissa of the extended type, then one rounding
    assert np.finfo(np.longdouble).nmant >= 63
    ang = eang[rows, b].astype(np.longdouble)
    deg = (ang * np.longdouble(_RAD_TO_DEG) - 90).astype(F32)
    return (nxh * inv + nxl * inv, nyh * inv + nyl * inv,
            dv[rows, b] / bl, du[rows, b] / bl, deg), (m_h, m_l)


def _pmod(a, n):
    return np.mod(a, n)


def cv2_centers_emulated(rmin, rmax, rvalid, min_y, cl, cr, isq):
    """csrc/cv2_centers.cu's design: one warp per component (axis 1 = the
    32 lanes); returns (cx, cy, ok) with 0 where ok is False, and the
    number of in-band candidates."""
    d, r = rmin.shape
    lanes = np.arange(32)
    rows = np.arange(r)
    h = rvalid.sum(1)
    last_valid = np.where(rvalid, rows, -1).max(1)
    x0 = np.where(rvalid, rmin, BIG).min(1).astype(np.int64)
    xmax = np.where(rvalid, rmax, -BIG).max(1).astype(np.int64)
    ok = (h > 0) & (last_valid == h - 1) & (xmax - x0 < tcc._w_limit(r))
    # the cycle, 32 entries a ballot
    top_single = rmin[:, 0] == rmax[:, 0]
    last = np.clip(h - 1, 0, r - 1)
    bot_single = rmin[np.arange(d), last] == rmax[np.arange(d), last]
    n = np.zeros(d, np.int64)
    vx = np.zeros((d, 33), np.int64)
    vy = np.zeros((d, 33), np.int64)
    for e0 in range(0, 2 * r, 32):
        e = e0 + lanes
        right = e < r
        y = np.where(right, e, 2 * r - 1 - e)
        inside = e < 2 * r
        yc = np.clip(y, 0, r - 1)
        flag = inside[None, :] & rvalid[:, yc] & np.where(
            right[None, :], cr[:, yc] & ((y != 0)[None, :] |
                                         ~top_single[:, None]),
            cl[:, yc] & ((yc[None, :] != last[:, None]) |
                         ~bot_single[:, None]))
        x = np.where(right[None, :], rmax[:, yc], rmin[:, yc]) - x0[:, None]
        pos = n[:, None] + np.cumsum(flag, 1) - flag
        put = flag & (pos < 32) & ok[:, None]
        ci, li = np.nonzero(put)
        vx[ci, pos[ci, li]] = x[ci, li]
        vy[ci, pos[ci, li]] = np.broadcast_to(y, flag.shape)[ci, li]
        n += flag.sum(1)
    ok &= n <= 32
    cx = np.zeros(d, F32)
    cy = np.zeros(d, F32)
    n_band = np.zeros(d, np.int64)
    # a single point or a line
    deg = ok & (n <= 2)
    p0x = (vx[:, 0] + x0).astype(F32)
    p0y = (vy[:, 0] + min_y).astype(F32)
    p1x = (vx[:, 1] + x0).astype(F32)
    p1y = (vy[:, 1] + min_y).astype(F32)
    cx[deg] = np.where(n == 1, p0x, (p0x + p1x) * F32(0.5))[deg]
    cy[deg] = np.where(n == 1, p0y, (p0y + p1y) * F32(0.5))[deg]
    full = ok & (n > 2)
    if not full.any():
        return cx, cy, ok, n_band
    sel = np.nonzero(full)[0]
    vx, vy, nn = vx[sel], vy[sel], n[sel][:, None]
    ds_ = len(sel)
    vvalid = lanes[None, :] < nn
    nxt = np.where(lanes[None, :] == nn - 1, 0, (lanes[None, :] + 1) & 31)
    dx = np.take_along_axis(vx, nxt, 1) - vx[:, :32]
    dy = np.take_along_axis(vy, nxt, 1) - vy[:, :32]
    vxl, vyl = vx[:, :32], vy[:, :32]
    ymax = np.where(vvalid, vyl, -BIG).max(1, keepdims=True)
    xvmax = np.where(vvalid, vxl, -BIG).max(1, keepdims=True)
    xvmin = np.where(vvalid, vxl, BIG).min(1, keepdims=True)

    def first(cond):
        return np.where(cond.any(1), cond.argmax(1), 0)

    seq0 = np.stack([first(vvalid & (vyl == 0)),
                     first(vvalid & (vxl == xvmax)),
                     first(vvalid & (vyl == ymax)),
                     first(vvalid & (vxl == xvmin))], 1)
    bot0 = seq0[:, :1]
    rel_s = _pmod(lanes[None, :] - bot0, nn)
    r1 = _pmod(seq0[:, 1:2] - bot0, nn)
    q2 = _pmod(seq0[:, 2:3] - bot0, nn)
    q3 = _pmod(seq0[:, 3:4] - bot0, nn)
    r2 = q2 + np.where(q2 < r1, nn, 0)
    r3 = q3 + nn * np.where(q3 >= r2, 0, np.where(q3 + nn >= r2, 1, 2))
    arc = (1 + (r1 <= rel_s) + (r2 <= rel_s) + (r3 <= rel_s) - 1)
    cdx = np.select([arc == 0, arc == 1, arc == 2], [dx, dy, -dx], -dy)
    cdy = np.select([arc == 0, arc == 1, arc == 2], [dy, -dx, -dy], dx)
    with np.errstate(all='ignore'):
        tan_key = np.where(vvalid, cdy.astype(F32) / cdx.astype(F32),
                           F32(np.inf))
    arc_key = np.where(vvalid, arc, 4)
    dxf, dyf = dx.astype(F32), dy.astype(F32)
    umin = np.full((ds_, 32), np.inf, F32)
    umax = np.full((ds_, 32), -np.inf, F32)
    vmin, vmax = umin.copy(), umax.copy()
    for p in range(32):
        has = (p < nn)[:, 0]
        px = vx[:, p:p + 1].astype(F32)
        py = vy[:, p:p + 1].astype(F32)
        u = dxf * px + dyf * py
        v = dxf * py - dyf * px
        umin[has] = np.minimum(umin, u)[has]
        umax[has] = np.maximum(umax, u)[has]
        vmin[has] = np.minimum(vmin, v)[has]
        vmax[has] = np.maximum(vmax, v)[has]
    l2f = np.maximum((dx * dx + dy * dy).astype(F32), F32(1))
    with np.errstate(all='ignore'):
        area_sur = np.where(vvalid, (umax - umin) * (vmax - vmin) / l2f,
                            F32(np.inf))
    min_sur = area_sur.min(1, keepdims=True)
    band = min_sur * F32(1.0 + 2.0 ** -14) + F32(1e-30)
    in_band = vvalid & (area_sur <= band)
    good = in_band.sum(1) <= 8
    n_band[sel] = in_band.sum(1)
    # the rank count: the 8 smallest, the lower slot first on ties
    rank = ((area_sur[:, None, :] < area_sur[:, :, None]) |
            ((area_sur[:, None, :] == area_sur[:, :, None]) &
             (lanes[None, None, :] < lanes[None, :, None]))).sum(2)
    cand = np.argsort(rank, 1)[:, :8]
    assert (np.take_along_axis(rank, cand, 1) == np.arange(8)).all()
    pick = (lambda a: np.take_along_axis(a, cand, 1))
    cvalid = pick(in_band)
    ctan = pick(tan_key) + F32(0)
    carc = pick(arc_key)
    emask = vvalid[:, None, :]
    earlier = emask & ((tan_key[:, None, :] < ctan[:, :, None]) |
                       ((tan_key[:, None, :] == ctan[:, :, None]) &
                        (arc_key[:, None, :] < carc[:, :, None])))
    cnt = np.stack([(earlier & (arc[:, None, :] == q)).sum(2)
                    for q in range(4)], 1)                       # (d, 4, 8)
    tgt = _pmod(seq0[:, :, None] + cnt, nn[:, :, None])
    cend = _pmod(cand + 1, nn)
    tgt = np.where(carc[:, None, :] == np.arange(4)[None, :, None],
                   cend[:, None, :], tgt)
    tgt = np.minimum(tgt, 32)
    sx = np.take_along_axis(vx, tgt.reshape(ds_, -1), 1).reshape(
        ds_, 4, 8).astype(F32)
    sy = np.take_along_axis(vy, tgt.reshape(ds_, -1), 1).reshape(
        ds_, 4, 8).astype(F32)
    ex, ey = pick(dx), pick(dy)
    vlen2 = ex * ex + ey * ey
    good &= (((vlen2 < len(isq)) | ~cvalid)).all(1)
    iv = isq[np.clip(vlen2, 0, len(isq) - 1)]
    lx, ly = ex.astype(F32) * iv, ey.astype(F32) * iv
    conds = [carc == 0, carc == 1, carc == 2]
    a = np.select(conds, [lx, ly, -lx], -ly)
    b = np.select(conds, [ly, -lx, -ly], lx)
    rwidth = (sx[:, 1] - sx[:, 3]) * a + (sy[:, 1] - sy[:, 3]) * b
    rheight = (sy[:, 2] - sy[:, 0]) * a + (-(sx[:, 2] - sx[:, 0])) * b
    area = np.where(cvalid, rwidth * rheight, F32(np.inf))
    min_area = area.min(1, keepdims=True)
    later = (cvalid[:, None, :] & ((ctan[:, :, None] > ctan[:, None, :]) |
                                   ((ctan[:, :, None] == ctan[:, None, :]) &
                                    (carc[:, :, None] > carc[:, None, :])))
             ).sum(2)
    tie_rank = np.where(area == min_area, later, -1)
    win = tie_rank.argmax(1)[:, None]

    def g(arr):
        return np.take_along_axis(arr, win, 1)[:, 0] + F32(0)

    wa, wb, ww, wh = g(a), g(b), g(rwidth), g(rheight)
    wsx = [g(sx[:, q]) for q in range(4)]
    wsy = [g(sy[:, q]) for q in range(4)]
    x0f = x0[sel].astype(F32)
    y0f = min_y[sel].astype(F32)
    lxx, lyy = wsx[3] + x0f, wsy[3] + y0f
    bxx, byy = wsx[0] + x0f, wsy[0] + y0f
    nb = -wb
    cc1 = lxx * wa + lyy * wb
    cc2 = bxx * nb + byy * wa
    det = wa * wa + (-nb) * wb
    idet = F32(1) / det
    px = (cc1 * wa + (-cc2) * wb) * idet
    py = (cc2 * wa + (-cc1) * nb) * idet
    cx[sel] = (wa * ww + nb * wh) * F32(0.5) + px
    cy[sel] = (wb * ww + wa * wh) * F32(0.5) + py
    ok[sel] &= good
    return np.where(ok, cx, F32(0)), np.where(ok, cy, F32(0)), ok, n_band


# ---------------------------------------------------------------- tests

def _np(ts):
    return [t.numpy() for t in ts]


def _design_inputs():
    blobs, r = edge_case_blobs()
    return blobs + fuzz_blobs(1200, 31), r


@pytest.fixture(scope='module')
def design_inputs():
    blobs, r = _design_inputs()
    return blobs, r, cv2_inputs(blobs, r), rect_inputs(blobs, r)


def test_cv2_design_matches_plain(design_inputs):
    blobs, r, args, _ = design_inputs
    cx, cy, ok = _np(tcc.cv2_centers_from_tables_plain(*args, max_bh=r))
    ecx, ecy, eok, n_band = cv2_centers_emulated(*_np(args))
    np.testing.assert_array_equal(eok, ok)
    np.testing.assert_array_equal(ecx[ok].view(np.int32),
                                  cx[ok].view(np.int32))
    np.testing.assert_array_equal(ecy[ok].view(np.int32),
                                  cy[ok].view(np.int32))
    # the edge cases are there: no row, > 32 corners, > 8 in band, the
    # table, and most fuzz components take the cv2-exact path
    assert not ok[0] and ok[1:6].all()
    assert not ok[6] and not ok[7]
    assert n_band[8] > 8 and not ok[8]
    assert not ok[9] and not ok[10]
    assert ok.sum() > 1100


def test_rect_design_matches_plain(design_inputs):
    _, _, _, (chains, sel_args) = design_inputs
    want = _np(lb.edge_finish_plain(*chains))
    got = edge_finish_emulated(*_np(chains))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(w.dtype), w)
    want = _np(lb.rect_select_plain(*sel_args))
    got, (m_h, m_l) = rect_select_emulated(*_np(sel_args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    # the warp's butterfly minimum is the halving tree's, bit for bit
    a = _np(sel_args)
    d = a[0].shape[0]
    ev = np.concatenate([a[7], np.ones((d, 1), bool)], 1)
    ah, al, *_ = _ds_area(*a[:6], ev)
    t_h, t_l = halving_tree_min(ah, al)
    np.testing.assert_array_equal(m_h.view(np.int32), t_h.view(np.int32))
    np.testing.assert_array_equal(m_l.view(np.int32), t_l.view(np.int32))


def test_rect_design_ties_and_odd_widths():
    """Equal areas in many lanes and K from 1 to 70 (a lane with no
    candidate, lanes with three): the emulated warp equals the plain
    version and its minimum the halving tree's."""
    rng = np.random.default_rng(3)
    for k in (1, 2, 31, 32, 33, 64, 70):
        d = 300
        mnu = rng.integers(-40, 0, (d, k)).astype(F32)
        mxu = mnu + rng.integers(0, 6, (d, k)).astype(F32)
        mnv = rng.integers(-40, 0, (d, k)).astype(F32)
        mxv = mnv + rng.integers(0, 6, (d, k)).astype(F32)
        dx = rng.integers(1, 4, (d, k)).astype(F32)
        dy = rng.integers(0, 4, (d, k)).astype(F32)
        dx[:, -1], dy[:, -1] = 1, 0
        ang = rng.choice(np.array([0.0, -0.0, 0.25, 0.5], F32), (d, k - 1))
        valid = rng.random((d, k - 1)) < 0.7
        mnu[:5], mxu[:5] = 3e38, -3e38                  # no valid point
        args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
                (mnu, mxu, mnv, mxv, dx, dy, ang, valid)]
        want = _np(lb.rect_select_plain(*args))
        got, (m_h, m_l) = rect_select_emulated(*_np(args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        ev = np.concatenate([valid, np.ones((d, 1), bool)], 1)
        t_h, t_l = halving_tree_min(*_ds_area(mnu, mxu, mnv, mxv, dx, dy,
                                              ev)[:2])
        np.testing.assert_array_equal(m_h.view(np.int32), t_h.view(np.int32))
        np.testing.assert_array_equal(m_l.view(np.int32), t_l.view(np.int32))


@pytest.mark.parametrize('seed', [7, 8])
def test_plain_versions_match_jax(seed):
    """edge_finish_plain and the rect against XLA:CPU on fuzz blobs (cv2
    centres: tests/test_torch_cv2_centers.py and the next test)."""
    r = 24
    blobs = fuzz_blobs(160, seed)
    chains, sel_args = rect_inputs(blobs, r)
    got = _np(lb.edge_finish_plain(*chains))
    c = _np(chains)
    left = jlb._edge_vector_finish(*(jnp.asarray(a) for a in c[:3]), r)
    right = jlb._edge_vector_finish(*(jnp.asarray(a) for a in c[3:]), r)
    for g, a, b in zip(got, left, right):
        want = np.concatenate([np.asarray(a), np.asarray(b)], 1)
        np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8))
    rmin, rmax, rvalid, min_y = (torch.from_numpy(a) for a in
                                 cases.row_tables(blobs, r))
    tabs = lb._stats_tail_from_tables(rmin, rmax, rvalid, min_y, max_bh=r)
    port = lb.min_area_rect(tabs['points'], tabs['points_valid'],
                            tabs['edge_angles'], tabs['edge_valid'],
                            tabs['edge_dx'], tabs['edge_dy'])
    ref = jlb.min_area_rect(
        *(jnp.asarray(tabs[k].numpy()) for k in ('points', 'points_valid')),
        **{k: jnp.asarray(tabs[k].numpy()) for k in
           ('edge_angles', 'edge_valid', 'edge_dx', 'edge_dy')},
        use_pallas_sweep=False)
    for key in ('w', 'h', 'angle_deg'):
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    for key in ('cx', 'cy'):
        np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_cv2_plain_matches_jax_on_edge_cases():
    blobs, r = edge_case_blobs()
    args = cv2_inputs(blobs, r)
    cx, cy, ok = _np(tcc.cv2_centers_from_tables_plain(*args, max_bh=r))
    jx, jy, jok = (np.asarray(o) for o in jcc.cv2_centers_standalone(
        *(jnp.asarray(a.numpy()) for a in args[:4]),
        jcc.inv_sqrt_table(MAX_EDGE_W, r), max_bh=r))
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(cx[ok], jx[ok])
    np.testing.assert_array_equal(cy[ok], jy[ok])


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    blobs, r = edge_case_blobs()
    args = cv2_inputs(blobs, r)
    chains, sel_args = rect_inputs(blobs, r)
    calls = ((lambda *a: tcc.cv2_centers_from_tables(*a, max_bh=r),
              lambda *a: tcc.cv2_centers_from_tables_plain(*a, max_bh=r),
              args, tcc.cv2_centers_from_tables),
             (rect.edge_finish, lb.edge_finish_plain, chains,
              rect.edge_finish),
             (rect.rect_select, lb.rect_select_plain, sel_args,
              rect.rect_select))
    for wrapper, plain, a, counted in calls:
        before = counted.launches
        for g, w in zip(wrapper(*a), plain(*a)):
            assert torch.equal(g, w)
        assert counted.launches == before
        with pytest.raises(ValueError, match='unsupported device'):
            wrapper(*(t.to('meta') for t in a))


# ------------------------------------------------------- on the card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _assert_cv2_equal(got, want):
    gx, gy, gok = (t.cpu().numpy() for t in got)
    wx, wy, wok = (t.cpu().numpy() for t in want)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gx[wok].view(np.int32),
                                  wx[wok].view(np.int32))
    np.testing.assert_array_equal(gy[wok].view(np.int32),
                                  wy[wok].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['design', 'edge', 'fuzz_r24'])
def test_kernels_match_plain_on_cuda(case):
    """Each kernel against its plain version on the card, one launch a
    call: cv2 ``ok`` everywhere and the centres where it holds, the edge
    finish and the rect select bit for bit."""
    dev = _cuda_or_skip()
    if case == 'design':
        blobs, r = _design_inputs()
    elif case == 'edge':
        blobs, r = edge_case_blobs()
    else:
        blobs, r = fuzz_blobs(3000, 5), 24
    args = [a.to(dev) for a in cv2_inputs(blobs, r)]
    before = tcc.cv2_centers_from_tables.launches
    got = tcc.cv2_centers_from_tables(*args, max_bh=r)
    torch.cuda.synchronize()
    assert tcc.cv2_centers_from_tables.launches == before + 1
    _assert_cv2_equal(got, tcc.cv2_centers_from_tables_plain(*args,
                                                             max_bh=r))
    chains, sel_args = rect_inputs(blobs, r)
    for fn, plain, a in ((rect.edge_finish, lb.edge_finish_plain, chains),
                         (rect.rect_select, lb.rect_select_plain,
                          sel_args)):
        a = [t.to(dev) for t in a]
        before = fn.launches
        got = fn(*a)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for g, w in zip(got, plain(*a)):
            assert g.dtype == w.dtype and torch.equal(
                g.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.cuda
def test_kernels_on_cuda_at_odd_sizes():
    """D no multiple of a block's warps, R = 1 and 2 (no or one edge slot
    a chain), K = 1, all-empty tables, and the rect's random ties."""
    dev = _cuda_or_skip()
    for r, n in ((1, 5), (2, 33), (3, 7), (48, 129)):
        blobs = fuzz_blobs(n, r)
        blobs = [(xs, ys) if np.ptp(ys) < r else None for xs, ys in blobs]
        blobs += [None] * 3
        args = [a.to(dev) for a in cv2_inputs(blobs, r)]
        _assert_cv2_equal(tcc.cv2_centers_from_tables(*args, max_bh=r),
                          tcc.cv2_centers_from_tables_plain(*args, max_bh=r))
        chains, sel_args = rect_inputs(blobs, r)
        for fn, plain, a in ((rect.edge_finish, lb.edge_finish_plain,
                              chains),
                             (rect.rect_select, lb.rect_select_plain,
                              sel_args)):
            a = [t.to(dev) for t in a]
            for g, w in zip(fn(*a), plain(*a)):
                assert torch.equal(g, w)
    rng = np.random.default_rng(3)
    for k in (1, 33, 70):
        d = 300
        mnu = rng.integers(-40, 0, (d, k)).astype(F32)
        mxu = mnu + rng.integers(0, 6, (d, k)).astype(F32)
        mnv = rng.integers(-40, 0, (d, k)).astype(F32)
        mxv = mnv + rng.integers(0, 6, (d, k)).astype(F32)
        dx = rng.integers(1, 4, (d, k)).astype(F32)
        dy = rng.integers(0, 4, (d, k)).astype(F32)
        ang = rng.choice(np.array([0.0, -0.0, 0.25], F32), (d, k - 1))
        valid = rng.random((d, k - 1)) < 0.7
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
             (mnu, mxu, mnv, mxv, dx, dy, ang, valid)]
        for g, w in zip(rect.rect_select(*a), lb.rect_select_plain(*a)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
