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
  operation, the kernel's order): the cv2 centres' warp per component as
  32 lanes, the ballot compaction, the in-band lanes' rank and the
  inverse square root computed in float64; the rect select's groups of
  4, 8 or 16 lanes, the flag scan's prefix count, the kept and overflow
  candidates, the group butterflies of the double-single areas and of
  the angle argmax. Bit-equal to the plain version on ~1200 fuzz
  components plus the edge cases: no valid row, a single point, lines,
  more than 32 strict corners, more than 8 in-band candidates, an edge
  vector past the inverse-sqrt table, equal surrogate areas and equal
  angles, and the cases of ``rect_tail_cases`` that split the layouts
  unevenly (exactly 8 and 9 in-band edges, |v|^2 on the table's last
  entry and one past it, every rect candidate valid, none, K = 1, 2,
  127, 191).
- fdlibm's ``atan2f`` in the kernel's scalar C order, emulated in numpy
  float32, against the plain ``_atan2_f32`` and ``jnp.arctan2`` over
  every folded integer vector with 0 <= dy <= 256, 1 <= dx <= 256.
- ``cuda``-marked twins hold each kernel bit-equal to its plain version on
  the card, also on the uneven cases and at R = 1000, and prove the two
  square roots the kernels compute over every float32 >= 0 and a 16.8
  M-entry table (they skip here).

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
    *_, cl, cr, _ = lb._hull_edge_data(rmin, rmax, rvalid, min_y)
    isq = tcc.inv_sqrt_table(MAX_EDGE_W, r)
    return rmin, rmax, rvalid, min_y, cl, cr, isq


def rect_inputs(blobs, r):
    """The edge-finish and rect-select inputs of the blobs' tables: the
    hull's chain outputs, the sweep's extents (the appended (1, 0) last),
    the edge candidates, their angles and validity."""
    rmin, rmax, rvalid, min_y = (torch.from_numpy(a) for a in
                                 cases.row_tables(blobs, r))
    tabs = lb._stats_tail_from_tables(rmin, rmax, rvalid, min_y)
    chains = lb.hull_tables_plain(rmin, rmax, rvalid, min_y)[:6]
    ext = lb.sweep_tables_plain(*(tabs[k] for k in lb.SWEEP_KEYS))
    return chains, (*ext, *(tabs[k] for k in ('edge_dx', 'edge_dy',
                                              'edge_angles', 'edge_valid')))


def with_axis(sel):
    """The rect select's extents and its (D, K - 1) directions with the
    appended (1, 0): the six (D, K) arrays of the candidates' areas."""
    d = sel[0].shape[0]
    return list(sel[:4]) + [
        np.concatenate([sel[4], np.ones((d, 1), F32)], 1),
        np.concatenate([sel[5], np.zeros((d, 1), F32)], 1)]


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


#: csrc/rect.cu's rect select: the lanes of a component's group and the
#: valid candidates a group keeps in registers
LANES = 8
KEPT = 16


def group_layout(evalid, lanes, kept):
    """The rect select's scan as the group runs it, 16 * ``lanes``
    candidates at a time: lane gl counts the valid flags of candidates
    k0 + 16 gl ... + 15 and a prefix sum over the group numbers them in
    index order; the first ``kept`` go to lane p % lanes (slot p //
    lanes), the valid ones after the last kept one to lane (k - over0) %
    lanes in index order. Returns (at, n, first_inv): at (D, lanes,
    steps) the candidate a lane takes at each step (-1: none), n the valid
    count, first_inv the first invalid index (K: none)."""
    d, k = evalid.shape
    n = np.zeros(d, np.int64)
    num = np.full((d, k), -1)
    first_inv = np.full(d, k)
    span = 16 * lanes
    for k0 in range(0, k, span):
        f = np.zeros((d, span), bool)
        f[:, :min(span, k - k0)] = evalid[:, k0:k0 + span]
        f = f.reshape(d, lanes, 16)
        cnt = f.sum(2)
        start = n[:, None] + np.cumsum(cnt, 1) - cnt      # the prefix sum
        p = start[:, :, None] + np.cumsum(f, 2) - f
        num[:, k0:k0 + span] = np.where(f, p, -1).reshape(d, span)[
            :, :min(span, k - k0)]
        inv = ~evalid[:, k0:k0 + span]
        hit = (first_inv == k) & inv.any(1)
        first_inv[hit] = k0 + inv[hit].argmax(1)
        n += cnt.sum(1)
    idx = np.arange(k)[None, :]
    last_kept = np.where(num == kept - 1, idx, -1).max(1)
    over0 = np.where(n > kept, last_kept + 1, k)[:, None]
    lane = np.where(num < kept, num % lanes, (idx - over0) % lanes)
    step = np.where(num < kept, num // lanes,
                    kept // lanes + (idx - over0) // lanes)
    steps = int(step[evalid].max()) + 1
    at = np.full((d, lanes, steps), -1)
    ci, ki = np.nonzero(evalid)
    at[ci, lane[ci, ki], step[ci, ki]] = ki
    return at, n, first_inv


def _butterfly(vals, take, lanes):
    """A butterfly of xor shuffles over the group's lanes (axis 1):
    ``take(own, other)`` says where a lane takes its partner's values."""
    for off in [1 << i for i in range(lanes.bit_length() - 2, -1, -1)]:
        src = np.arange(lanes) ^ off
        other = [v[:, src] for v in vals]
        t = take(vals, other)
        vals = [np.where(t, o, v) for v, o in zip(vals, other)]
    return vals


def rect_select_emulated(mnu, mxu, mnv, mxv, edx, edy, eang, evalid,
                         lanes=LANES, kept=KEPT):
    """csrc/rect.cu's rect-select kernel: a group of ``lanes`` lanes per
    component (axis 1), the scan's compaction, each lane's candidates in
    its order, the butterflies over the group; returns the outputs and
    the group minimum (h, l) of the areas."""
    d, k = mnu.shape
    # the appended candidate: (1, 0), angle 0, valid, formed by the kernel
    edx, edy = with_axis((mnu, mxu, mnv, mxv, edx, edy))[4:]
    eang = np.concatenate([eang, np.zeros((d, 1), F32)], 1)
    evalid = np.concatenate([evalid, np.ones((d, 1), bool)], 1)
    ah, al, du, dv, l2 = _ds_area(mnu, mxu, mnv, mxv, edx, edy, evalid)
    at, n, first_inv = group_layout(evalid, lanes, kept)
    rows = np.arange(d)[:, None]
    # pass 1: an invalid candidate's (BIG_F, 0) starts the minimum
    some_inv = np.broadcast_to((n < k)[:, None], (d, lanes))
    mh = np.where(some_inv, F32(3e38), F32(np.inf)).astype(F32)
    ml = np.zeros((d, lanes), F32)
    have = some_inv.copy()
    for st in range(at.shape[2]):
        kk = at[:, :, st]
        got = kk >= 0
        kc = np.maximum(kk, 0)
        take = got & (~have | _less(ah[rows, kc], al[rows, kc], mh, ml))
        mh = np.where(take, ah[rows, kc], mh)
        ml = np.where(take, al[rows, kc], ml)
        have |= got
    mh, ml, have = _butterfly(
        [mh, ml, have], lambda v, o: o[2] & (~v[2] | _less(o[0], o[1], v[0],
                                                           v[1])), lanes)
    assert (mh == mh[:, :1]).all()
    m_h, m_l = mh[:, 0], ml[:, 0]
    # pass 2: the tie band; each lane's largest angle, the lower index on
    # equal ones; lane 0 also takes the first invalid candidate at -1
    band = m_h * F32(1e-9) + F32(1e-9)
    diff, _ = _ds_add(ah, al, -m_h[:, None], -m_l[:, None])
    val = np.where(evalid & (diff <= band[:, None]), eang, F32(-1))
    best = np.full((d, lanes), -np.inf, F32)
    bk = np.full((d, lanes), k)

    def better(v, kx, b, bkx):
        return (v > b) | ((v == b) & (kx < bkx))

    for st in range(at.shape[2]):
        kk = at[:, :, st]
        kc = np.maximum(kk, 0)
        take = (kk >= 0) & better(val[rows, kc], kk, best, bk)
        best = np.where(take, val[rows, kc], best)
        bk = np.where(take, kk, bk)
    inv = first_inv < k
    t0 = inv & better(F32(-1), first_inv, best[:, 0], bk[:, 0])
    best[t0, 0], bk[t0, 0] = -1, first_inv[t0]
    best, bk = _butterfly([best, bk], lambda v, o: better(o[0], o[1], v[0],
                                                          v[1]), lanes)
    b = bk[:, 0]
    rows = np.arange(d)
    bdx, bdy, bl2 = edx[rows, b], edy[rows, b], l2[rows, b]
    bl = np.sqrt(bl2)                   # __fsqrt_rn: correctly rounded
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


def inv_sqrt_computed(v):
    """csrc/cv2_centers.cu's inverse square root of an index v of the
    table: f32(1 / sqrt(f64(v))), two float64 operations and one rounding
    (entry 0 is 1)."""
    v = np.asarray(v, np.float64)
    return (1.0 / np.sqrt(np.maximum(v, 1.0))).astype(F32)


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
    n_band[sel] = in_band.sum(1)
    good = in_band.sum(1) <= 8
    # the in-band lanes rank themselves against the other in-band lanes,
    # (area, slot) order, and count the in-band lanes visited before them
    # (tangent key, arc)
    ib_i = in_band[:, None, :]
    rank = (ib_i & ((area_sur[:, None, :] < area_sur[:, :, None]) |
                    ((area_sur[:, None, :] == area_sur[:, :, None]) &
                     (lanes[None, None, :] < lanes[None, :, None])))).sum(2)
    later = (ib_i & ((tan_key[:, :, None] > tan_key[:, None, :]) |
                     ((tan_key[:, :, None] == tan_key[:, None, :]) &
                      (arc[:, :, None] > arc[:, None, :])))).sum(2)
    # each in-band lane's calipers from its own edge
    emask = vvalid[:, None, :]
    earlier = emask & ((tan_key[:, None, :] < tan_key[:, :, None]) |
                       ((tan_key[:, None, :] == tan_key[:, :, None]) &
                        (arc[:, None, :] < arc[:, :, None])))   # (d, 32, 32)
    cnt = np.stack([(earlier & (arc[:, None, :] == q)).sum(2)
                    for q in range(4)], 1)                       # (d, 4, 32)
    tgt = _pmod(seq0[:, :, None] + cnt, nn[:, :, None])
    cend = _pmod(lanes[None, :] + 1, nn)
    tgt = np.where(arc[:, None, :] == np.arange(4)[None, :, None],
                   cend[:, None, :], tgt)
    tgt = np.minimum(tgt, 32)
    sx = np.take_along_axis(vx, tgt.reshape(ds_, -1), 1).reshape(
        ds_, 4, 32).astype(F32)
    sy = np.take_along_axis(vy, tgt.reshape(ds_, -1), 1).reshape(
        ds_, 4, 32).astype(F32)
    vlen2 = dx * dx + dy * dy
    good &= ((vlen2 < len(isq)) | ~in_band).all(1)
    iv = inv_sqrt_computed(np.clip(vlen2, 0, len(isq) - 1))
    lx, ly = dx.astype(F32) * iv, dy.astype(F32) * iv
    conds = [arc == 0, arc == 1, arc == 2]
    a = np.select(conds, [lx, ly, -lx], -ly)
    b = np.select(conds, [ly, -lx, -ly], lx)
    rwidth = (sx[:, 1] - sx[:, 3]) * a + (sy[:, 1] - sy[:, 3]) * b
    rheight = (sy[:, 2] - sy[:, 0]) * a + (-(sx[:, 2] - sx[:, 0])) * b
    area = np.where(in_band, rwidth * rheight, F32(np.inf))
    min_area = area.min(1, keepdims=True)
    # the winner: the largest count, then the lower rank
    key = np.where(in_band & (area == min_area), later * 64 + 63 - rank, -1)
    win = key.argmax(1)[:, None]
    assert (np.take_along_axis(key, win, 1) >= 0).all()

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
    with np.errstate(all='ignore'):
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
    ah, al, *_ = _ds_area(*with_axis(a), ev)
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
                (mnu, mxu, mnv, mxv, dx[:, :-1], dy[:, :-1], ang, valid)]
        want = _np(lb.rect_select_plain(*args))
        got, (m_h, m_l) = rect_select_emulated(*_np(args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        ev = np.concatenate([valid, np.ones((d, 1), bool)], 1)
        t_h, t_l = halving_tree_min(*_ds_area(mnu, mxu, mnv, mxv, dx, dy,
                                              ev)[:2])
        np.testing.assert_array_equal(m_h.view(np.int32), t_h.view(np.int32))
        np.testing.assert_array_equal(m_l.view(np.int32), t_l.view(np.int32))


def _select_case(case):
    _, k, d, frac = next(c for c in cases.SELECT_CASES if c[0] == case)
    return cases.select_arrays(np.random.default_rng(k * 7919 + d), k, d,
                               frac)


@pytest.mark.parametrize('lanes', [4, 8, 16])
@pytest.mark.parametrize('case', [c[0] for c in cases.SELECT_CASES])
def test_rect_design_uneven_splits(case, lanes):
    """The group layout on inputs that split it unevenly (every candidate
    valid: more than a group keeps; none valid; K = 1, 2, 127, 191; D no
    multiple of a block's groups), at 4, 8 and 16 lanes a group: the
    emulated kernel equals the plain version, its minimum the halving
    tree's."""
    a = _select_case(case)
    want = _np(lb.rect_select_plain(*(torch.from_numpy(x) for x in a)))
    got, (m_h, m_l) = rect_select_emulated(*a, lanes=lanes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    d = a[0].shape[0]
    ev = np.concatenate([a[7], np.ones((d, 1), bool)], 1)
    t_h, t_l = halving_tree_min(*_ds_area(*with_axis(a), ev)[:2])
    np.testing.assert_array_equal(m_h.view(np.int32), t_h.view(np.int32))
    np.testing.assert_array_equal(m_l.view(np.int32), t_l.view(np.int32))


def _band_or_table_inputs(case):
    """The cv2 inputs of ``rect_tail_cases``' band or table-edge blobs,
    the expected ``ok`` and in-band counts (None: not checked)."""
    r = 48
    if case == 'band':
        args = cv2_inputs(cases.band_blobs(), r)
        return args, r, [True, False, False], [8, 9, 9]
    args = cv2_inputs(cases.table_edge_blobs(), r)
    args = args[:6] + (tcc.inv_sqrt_table(*cases.TABLE_EDGE),)
    assert args[6].numel() == 26
    return args, r, [True, True, False, False], [4, 4, 4, 4]


@pytest.mark.parametrize('case', ['band', 'table'])
def test_cv2_design_band_and_table_edges(case):
    """Exactly 8 and 9 edges in the surrogate band, and in-band edges with
    |v|^2 at the inverse-sqrt table's last entry and one past it: the
    emulated kernel (the in-band rank, the computed inverse square root)
    equals the plain version, ``ok`` where expected."""
    args, r, want_ok, want_band = _band_or_table_inputs(case)
    cx, cy, ok = _np(tcc.cv2_centers_from_tables_plain(*args, max_bh=r))
    ecx, ecy, eok, n_band = cv2_centers_emulated(*_np(args))
    np.testing.assert_array_equal(eok, ok)
    np.testing.assert_array_equal(ecx[ok].view(np.int32),
                                  cx[ok].view(np.int32))
    np.testing.assert_array_equal(ecy[ok].view(np.int32),
                                  cy[ok].view(np.int32))
    assert ok.tolist() == want_ok and n_band.tolist() == want_band


def test_inv_sqrt_computed_equals_table():
    """The kernel's inverse square root, two float64 operations and one
    rounding, against the table over all its entries (R = 160's)."""
    tab = tcc.inv_sqrt_table(MAX_EDGE_W, cases.EDGE_CASE_ROWS).numpy()
    got = inv_sqrt_computed(np.arange(tab.size))
    np.testing.assert_array_equal(got.view(np.int32), tab.view(np.int32))


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
    tabs = lb._stats_tail_from_tables(rmin, rmax, rvalid, min_y)
    pts = lb.candidate_points(rmin, rmax, rvalid, min_y)
    port = lb.min_area_rect(*pts, tabs['edge_angles'], tabs['edge_valid'],
                            tabs['edge_dx'], tabs['edge_dy'])
    ref = jlb.min_area_rect(
        *(jnp.asarray(t.numpy()) for t in pts),
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
             (mnu, mxu, mnv, mxv, dx[:, :-1], dy[:, :-1], ang, valid)]
        for g, w in zip(rect.rect_select(*a), lb.rect_select_plain(*a)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('case', [c[0] for c in cases.SELECT_CASES])
def test_rect_select_on_cuda_uneven_splits(case):
    """The rect-select kernel against its plain version on the uneven
    cases of ``test_rect_design_uneven_splits``, one launch a call."""
    dev = _cuda_or_skip()
    a = [torch.from_numpy(x).to(dev) for x in _select_case(case)]
    before = rect.rect_select.launches
    got = rect.rect_select(*a)
    torch.cuda.synchronize()
    assert rect.rect_select.launches == before + 1
    for g, w in zip(got, lb.rect_select_plain(*a)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['band', 'table', 'tall'])
def test_cv2_centers_on_cuda_band_table_and_tall(case):
    """The cv2-centre kernel against its plain version on the 8 and 9
    in-band octagons, the table-edge squares (each at D = 4 k + 1 and
    4 k + 3 with fuzz components, D no multiple of a block's warps) and
    at R = 1000 (rows read from global memory, not staged); with the
    rect select at R = 1000 (K = 1999)."""
    dev = _cuda_or_skip()
    if case == 'tall':
        r = 1000
        blobs = fuzz_blobs(299, 9)
        blobs.append((np.arange(900) // 30 + 5, np.arange(900)))
        args = cv2_inputs(blobs, r)
        _, sel_args = rect_inputs(blobs, r)
        a = [t.to(dev) for t in sel_args]
        for g, w in zip(rect.rect_select(*a), lb.rect_select_plain(*a)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        variants = [args]
    else:
        base, r, want_ok, _ = _band_or_table_inputs(case)
        fill = cv2_inputs(fuzz_blobs(8, 4), r)
        d0 = base[0].shape[0]
        variants = [tuple(torch.cat([b, f[:(odd - d0) % 4 + 4]])
                          for b, f in zip(base[:6], fill[:6])) + base[6:]
                    for odd in (1, 3)]
        assert [v[0].shape[0] % 4 for v in variants] == [1, 3]
    for args in variants:
        args = [t.to(dev) for t in args]
        got = tcc.cv2_centers_from_tables(*args, max_bh=r)
        want = tcc.cv2_centers_from_tables_plain(*args, max_bh=r)
        torch.cuda.synchronize()
        _assert_cv2_equal(got, want)
        if case != 'tall':
            assert want[2][:len(want_ok)].tolist() == want_ok


@pytest.mark.cuda
def test_sqrt_f32_is_rounded_f64_sqrt_on_cuda():
    """The rect select's __fsqrt_rn against the float64 root rounded to
    float32 (the plain version's side length) over every finite float32
    >= 0 and -0, on the card: no value differs."""
    dev = _cuda_or_skip()
    from ysmr_tpu_torch import _build
    lib = _build.load_kernels()
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    _build.check(lib, lib.ysmr_rect_sqrt_mismatches(
        counts.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream), 'sqrt check')
    torch.cuda.synchronize()
    assert counts.tolist() == [0, 0x7f800001]


@pytest.mark.cuda
def test_inv_sqrt_entries_equal_table_on_cuda():
    """The cv2 kernel's inverse square roots against ``inv_sqrt_table``
    over a table of 16.8 M entries (every table with max_h <= 4096 is a
    prefix of it), on the card: bit-equal."""
    dev = _cuda_or_skip()
    from ysmr_tpu_torch import _build
    lib = _build.load_kernels()
    tab = tcc.inv_sqrt_table(MAX_EDGE_W, 4096, device=dev)
    got = torch.empty_like(tab)
    _build.check(lib, lib.ysmr_cv2_inv_sqrt(
        got.data_ptr(), tab.numel(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream), 'inverse sqrt')
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), tab.view(torch.int32))
