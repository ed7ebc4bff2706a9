"""Bit-exact cv2.minAreaRect centers from row-extreme tables (PyTorch).

Counterpart of ``ysmr_tpu/ops/cv2_centers.py`` (``inv_sqrt_table``,
``cv2_centers_from_tables``), whose docstring sets out how OpenCV's
sequential rotating calipers collapse into a closed form: the strict
corners of the row-extreme envelopes are cv2's hull in reverse contour
order, the caliper visit order is a sort by (in-quadrant tangent, caliper
index), and only the f32 area comparison and the f32 center arithmetic
are replicated literally, for at most ``_N_CAND`` near-minimal edges.

Differences from the JAX module, all of representation:

- The TPU avoided gathers with masked compare-select-reduces; here the
  corner compaction is one scatter and the per-candidate pulls are
  gathers. A float pull adds ``+ 0.0`` after the gather, because the JAX
  masked sum turns a -0.0 into +0.0.
- ``_dot2`` (XLA would contract ``a*b + c*d`` into an fma) is the plain
  two-rounding expression: PyTorch rounds every product on its own.
- ``lax.top_k`` of the negated areas is a stable ascending sort (both put
  the lower index first on ties).
- ``cv2_centers_from_tables_plain`` runs over chunks of components, so its
  (D, 32, 32) projection tensors stay small at dense capacities.

``cv2_centers_from_tables`` sends a CPU tensor to the plain version and a
CUDA tensor to the hand-written kernel ``csrc/cv2_centers.cu`` (one warp
per component, all components in one launch; its source notes the
design), or raises. Nothing falls back from the kernel to the plain
version. The kernel computes the inverse square roots as
:func:`inv_sqrt_table` does instead of reading them: the table must be
that function's (the plain version reads it).
"""

import functools

import numpy as np
import torch

from ysmr_tpu_torch import _build

__all__ = ['inv_sqrt_table', 'inv_sqrt_table_cached',
           'cv2_centers_from_tables', 'cv2_centers_from_tables_plain']

#: caliper candidates kept per component; more near-ties than this -> ok
#: False (exact-center fallback)
_N_CAND = 8

#: packed hull-corner slots per component; hulls with more strict corners
#: -> ok False (exact-center fallback)
_K_HULL = 32

#: components per chunk of cv2_centers_from_tables_plain
_CHUNK = 16384

_I32 = torch.int32
_F32 = torch.float32


def inv_sqrt_table(max_w, max_h, device=None):
    """f32 table t[v] = f32(1/sqrt(f64(v))) for v in [0, N), built on the
    host (v = dx^2 + dy^2 of an integer hull edge; t[0] is unused)."""
    n = int(max_w) ** 2 + int(max_h) ** 2 + 1
    v = np.arange(n, dtype=np.float64)
    v[0] = 1.0
    return torch.from_numpy((1.0 / np.sqrt(v)).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def inv_sqrt_table_cached(max_w, max_h, device):
    """:func:`inv_sqrt_table` on ``device``, built once per (max_w, max_h,
    device) and shared: the detect reads it every batch. Callers must not
    write to it."""
    return inv_sqrt_table(max_w, max_h, device=device)


def _dot2(x1, y1, x2, y2):
    """f32(x1*y1) + f32(x2*y2), both products rounded separately."""
    return x1 * y1 + x2 * y2


def _pick(a, idx):
    """a[d, idx[d, ...]] along axis 1; floats come out as the JAX masked
    sum gives them (-0.0 -> +0.0)."""
    out = torch.gather(a, 1, idx)
    return out + 0.0 if out.is_floating_point() else out


def _select(conds, vals, default):
    out = default
    for cond, val in reversed(list(zip(conds, vals))):
        out = torch.where(cond, val, out)
    return out


def _w_limit(r):
    """Widths below this keep the f32 slope/tan keys collision-free."""
    return (1 << 23) // max(r * r, 1)


def cv2_centers_from_tables(row_min_x, row_max_x, row_valid, min_y,
                            corner_l, corner_r, isq_table, *, max_bh):
    """cv2.minAreaRect centers (f32, bit-exact) from row-extreme tables
    (contract of :func:`cv2_centers_from_tables_plain`): the plain version
    on a CPU tensor, the kernel ``csrc/cv2_centers.cu`` on a CUDA one (one
    launch, counted in ``.launches``). Where ``ok`` is False the kernel's
    centre is 0."""
    dev = row_min_x.device
    if dev.type == 'cpu':
        return cv2_centers_from_tables_plain(
            row_min_x, row_max_x, row_valid, min_y, corner_l, corner_r,
            isq_table, max_bh=max_bh)
    if dev.type != 'cuda':
        raise ValueError('cv2_centers_from_tables: unsupported device '
                         '{}'.format(dev))
    if row_min_x.dim() != 2 or row_min_x.shape[1] != max_bh:
        raise ValueError('cv2_centers_from_tables: tables must have max_bh '
                         'rows')
    d, r = row_min_x.shape
    tabs = [a.contiguous() for a in (row_min_x, row_max_x, row_valid,
                                     min_y, corner_l, corner_r, isq_table)]
    for name, a, shape, dtype in zip(
            ('row_min_x', 'row_max_x', 'row_valid', 'min_y', 'corner_l',
             'corner_r'), tabs,
            ((d, r), (d, r), (d, r), (d,), (d, r), (d, r)),
            (torch.int32, torch.int32, torch.bool, torch.int32, torch.bool,
             torch.bool)):
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != dev:
            raise ValueError('cv2_centers_from_tables: {} must be a {} {} '
                             'tensor on {}'.format(name, shape, dtype, dev))
    tab_n = isq_table.numel()
    if isq_table.dim() != 1 or isq_table.dtype != _F32 or \
            isq_table.device != dev or not 0 < tab_n < 1 << 31:
        raise ValueError('cv2_centers_from_tables: isq_table must be a '
                         'non-empty 1-D float32 table on {}'.format(dev))
    cx = torch.empty(d, dtype=_F32, device=dev)
    cy = torch.empty(d, dtype=_F32, device=dev)
    ok = torch.empty(d, dtype=torch.bool, device=dev)
    lib = _build.load_kernels()
    # the kernel computes the table's entries (bit for bit) and reads only
    # its length
    rc = lib.ysmr_cv2_centers(
        *(a.data_ptr() for a in tabs[:6]), cx.data_ptr(), cy.data_ptr(),
        ok.data_ptr(), d, r, tab_n, _w_limit(r), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'cv2 centers kernel launch')
    cv2_centers_from_tables.launches += 1
    return cx, cy, ok


#: kernel launches since the count was last set to 0
cv2_centers_from_tables.launches = 0


def cv2_centers_from_tables_plain(row_min_x, row_max_x, row_valid, min_y,
                                  corner_l, corner_r, isq_table, *, max_bh):
    """cv2.minAreaRect centers (f32, bit-exact) from row-extreme tables.

    :param row_min_x, row_max_x: (D, R) int32 absolute x extremes per row
    :param row_valid: (D, R) bool (True on the component's bbox rows)
    :param min_y: (D,) int32 absolute top row
    :param corner_l, corner_r: (D, R) strict chain-corner masks
        (``labeling._hull_edge_data``)
    :param isq_table: 1-D f32 table from :func:`inv_sqrt_table`
    :param max_bh: R
    :return: (cx, cy, ok) — (D,) f32 centers and a bool mask; where ok is
        False the center is not cv2-exact (the caller falls back)
    """
    d = row_min_x.shape[0]
    outs = [torch.empty(d, dtype=_F32, device=row_min_x.device),
            torch.empty(d, dtype=_F32, device=row_min_x.device),
            torch.empty(d, dtype=torch.bool, device=row_min_x.device)]
    for s in range(0, d, _CHUNK):
        e = min(d, s + _CHUNK)
        part = _centers_chunk(row_min_x[s:e], row_max_x[s:e], row_valid[s:e],
                              min_y[s:e], corner_l[s:e], corner_r[s:e],
                              isq_table, max_bh=max_bh)
        for o, p in zip(outs, part):
            o[s:e] = p
    return tuple(outs)


def _centers_chunk(row_min_x, row_max_x, row_valid, min_y, corner_l,
                   corner_r, isq_table, *, max_bh):
    d, r = row_min_x.shape
    if r != max_bh:
        raise ValueError('cv2_centers_from_tables: tables must have max_bh '
                         'rows')
    dev = row_min_x.device
    c = _N_CAND
    kk = _K_HULL
    big = 1 << 30
    inf = float('inf')
    rows_i = torch.arange(r, dtype=_I32, device=dev)
    zero_i = torch.zeros_like(row_min_x)

    valid_any = row_valid.any(dim=1)
    h = row_valid.sum(dim=1, dtype=_I32)
    contiguous = (row_valid == (rows_i[None, :] < h[:, None])).all(dim=1)

    x0 = torch.where(row_valid, row_min_x, torch.full_like(row_min_x, big)
                     ).amin(dim=1)
    xmax = torch.where(row_valid, row_max_x, torch.full_like(row_max_x, -big)
                       ).amax(dim=1)
    width = xmax - x0
    # f32 slope/tan keys are collision-free only below this width
    w_ok = width < _w_limit(r)

    xl_min = torch.where(row_valid, row_min_x - x0[:, None], zero_i)
    xl_max = torch.where(row_valid, row_max_x - x0[:, None], zero_i)

    corn_r = corner_r & row_valid
    corn_l = corner_l & row_valid
    # seam dedup: a single-pixel top row keeps only its LEFT copy, a
    # single-pixel bottom row only its RIGHT copy
    top_single = xl_min[:, 0] == xl_max[:, 0]
    corn_r = corn_r & ((rows_i != 0)[None, :] | ~top_single[:, None])
    last = torch.clamp(h - 1, 0, r - 1)
    bot_single = torch.gather(xl_min == xl_max, 1, last[:, None].long())[:, 0]
    corn_l = corn_l & ((rows_i[None, :] != last[:, None]) |
                       ~bot_single[:, None])

    # hull cycle in order: right corners rows 0..R-1, then left corners
    # rows R-1..0 (the top-left vertex lands last)
    vx_w = torch.cat([xl_max, torch.flip(xl_min, [1])], dim=1)
    vy_w = torch.cat([rows_i.expand(d, r), torch.flip(rows_i, [0]).expand(
        d, r)], dim=1)
    vvalid_w = torch.cat([corn_r, torch.flip(corn_l, [1])], dim=1)
    vv_i = vvalid_w.to(_I32)
    n = vv_i.sum(dim=1, dtype=_I32)
    cyc_w = torch.cumsum(vv_i, dim=1, dtype=_I32) - vv_i

    # compact the corners to kk packed slots (cycle order kept); slot kk is
    # the dump of corners beyond kk and of non-corners
    slot = torch.where(vvalid_w & (cyc_w < kk), cyc_w,
                       torch.full_like(cyc_w, kk)).long()

    def compact(a):
        out = torch.zeros((d, kk + 1), dtype=_I32, device=dev)
        out.scatter_(1, slot, torch.where(vvalid_w, a, torch.zeros_like(a)))
        return out[:, :kk]

    vx = compact(vx_w)
    vy = compact(vy_w)
    jj = torch.arange(kk, dtype=_I32, device=dev)
    n_kk = torch.clamp(n, max=kk)
    vvalid = jj[None, :] < n_kk[:, None]
    n_ok = n <= kk

    # n <= 2: single point or line; the center is the f32 midpoint
    p0x = (vx[:, 0] + x0).to(_F32)
    p0y = (vy[:, 0] + min_y).to(_F32)
    p1x = (vx[:, 1] + x0).to(_F32)
    p1y = (vy[:, 1] + min_y).to(_F32)
    mid_cx = (p0x + p1x) * 0.5
    mid_cy = (p0y + p1y) * 0.5
    deg_cx = torch.where(n == 1, p0x, mid_cx)
    deg_cy = torch.where(n == 1, p0y, mid_cy)

    # edges: the next vertex is a shift in the packed table
    is_last = jj[None, :] == (n_kk - 1)[:, None]
    ex = torch.where(is_last, vx[:, :1], torch.cat([vx[:, 1:], vx[:, :1]], 1))
    ey = torch.where(is_last, vy[:, :1], torch.cat([vy[:, 1:], vy[:, :1]], 1))
    dx = ex - vx
    dy = ey - vy
    evalid = vvalid & (n[:, None] > 2)

    # initial caliper positions: first-occurrence extremes
    ymax = torch.where(vvalid, vy, torch.full_like(vy, -big)).amax(dim=1)
    xvmax = torch.where(vvalid, vx, torch.full_like(vx, -big)).amax(dim=1)
    xvmin = torch.where(vvalid, vx, torch.full_like(vx, big)).amin(dim=1)

    def first_slot(cond):
        return torch.argmax(cond.to(_I32), dim=1).to(_I32)

    bot0 = first_slot(vvalid & (vy == 0))
    right0 = first_slot(vvalid & (vx == xvmax[:, None]))
    top0 = first_slot(vvalid & (vy == ymax[:, None]))
    left0 = first_slot(vvalid & (vx == xvmin[:, None]))
    seq0 = torch.stack([bot0, right0, top0, left0], dim=1)    # (D, 4)

    # arcs: edge j belongs to caliper q when j lies in the cyclic span
    # [seq0[q], seq0[q+1]) from bot0, unwrapped to a monotone sequence
    n1 = torch.clamp(n, min=1)
    rel_s = torch.remainder(jj[None, :] - bot0[:, None], n1[:, None])
    rel_q = torch.remainder(seq0 - bot0[:, None], n1[:, None])
    r1_ = rel_q[:, 1]
    r2_ = rel_q[:, 2] + torch.where(rel_q[:, 2] < r1_, n1, torch.zeros_like(
        n1))
    r3_ = rel_q[:, 3] + n1 * torch.where(
        rel_q[:, 3] >= r2_, torch.zeros_like(n1),
        torch.where(rel_q[:, 3] + n1 >= r2_, torch.ones_like(n1),
                    torch.full_like(n1, 2)))
    rel_mono = torch.stack([torch.zeros_like(r1_), r1_, r2_, r3_], dim=1)
    arc = ((rel_mono[:, :, None] <= rel_s[:, None, :]).to(_I32).sum(
        dim=1, dtype=_I32) - 1)                                 # (D, kk)

    # canonical in-quadrant directions and visit keys
    a0, a1, a2 = arc == 0, arc == 1, arc == 2
    cdx = _select([a0, a1, a2], [dx, dy, -dx], -dy)
    cdy = _select([a0, a1, a2], [dy, -dx, -dy], dx)
    tan_key = cdy.to(_F32) / cdx.to(_F32)
    tan_key = torch.where(evalid, tan_key, torch.full_like(tan_key, inf))
    arc_key = torch.where(evalid, arc, torch.full_like(arc, 4))

    # candidate pruning by (approximate) exact area
    dxf_all = dx.to(_F32)
    dyf_all = dy.to(_F32)
    vxf = vx.to(_F32)
    vyf = vy.to(_F32)
    u = dxf_all[:, :, None] * vxf[:, None, :] + \
        dyf_all[:, :, None] * vyf[:, None, :]                   # (D, kk, kk)
    v = dxf_all[:, :, None] * vyf[:, None, :] - \
        dyf_all[:, :, None] * vxf[:, None, :]
    pmask = vvalid[:, None, :]
    pinf = torch.full_like(u, inf)
    du = torch.where(pmask, u, -pinf).amax(dim=2) - \
        torch.where(pmask, u, pinf).amin(dim=2)
    dv = torch.where(pmask, v, -pinf).amax(dim=2) - \
        torch.where(pmask, v, pinf).amin(dim=2)
    del u, v, pinf
    l2f = (dx * dx + dy * dy).to(_F32)
    area_sur = du * dv / torch.clamp(l2f, min=1.0)
    area_sur = torch.where(evalid, area_sur, torch.full_like(area_sur, inf))
    min_sur = area_sur.amin(dim=1, keepdim=True)
    band = min_sur * float(np.float32(1.0 + 2.0 ** -14)) + \
        float(np.float32(1e-30))
    in_band = evalid & (area_sur <= band)
    n_in_band = in_band.sum(dim=1, dtype=_I32)
    # the c smallest surrogate areas, lower slot first on ties
    cand_slot = torch.sort(area_sur, dim=1, stable=True).indices[:, :c]

    cvalid = _pick(in_band.to(_I32), cand_slot) > 0

    # supports for the candidates: visit comparisons against all edges
    ctan = _pick(tan_key, cand_slot)
    carc = _pick(arc_key, cand_slot)
    earlier = (tan_key[:, None, :] < ctan[:, :, None]) | \
        ((tan_key[:, None, :] == ctan[:, :, None]) &
         (arc_key[:, None, :] < carc[:, :, None]))              # (D, C, kk)
    earlier = earlier & evalid[:, None, :]
    cnt = torch.stack([(earlier & (arc[:, None, :] == q)).sum(
        dim=2, dtype=_I32) for q in range(4)], dim=1)           # (D, 4, C)

    tgt = torch.remainder(seq0[:, :, None] + cnt, n1[:, None, None])
    cend = _pick(torch.remainder(jj[None, :] + 1, n1[:, None]), cand_slot)
    arc_oh = carc[:, None, :] == torch.arange(4, device=dev)[None, :, None]
    tgt = torch.where(arc_oh, cend[:, None, :], tgt)
    # a target beyond the packed slots reads 0, as the masked sum does
    tgt_flat = torch.clamp(tgt.reshape(d, 4 * c), max=kk).long()
    vx_pad = torch.cat([vx, torch.zeros_like(vx[:, :1])], dim=1)
    vy_pad = torch.cat([vy, torch.zeros_like(vy[:, :1])], dim=1)
    sup_x = torch.gather(vx_pad, 1, tgt_flat).reshape(d, 4, c).to(_F32)
    sup_y = torch.gather(vy_pad, 1, tgt_flat).reshape(d, 4, c).to(_F32)

    # per-candidate f32 caliper arithmetic (cv2's exact op order)
    cdx_e = _pick(dx, cand_slot)
    cdy_e = _pick(dy, cand_slot)
    vlen2 = cdx_e * cdx_e + cdy_e * cdy_e
    tab_n = isq_table.shape[0]
    vlen_ok = (vlen2 < tab_n) | ~cvalid
    iv = isq_table[torch.clamp(vlen2, 0, tab_n - 1).long()]
    dxf = cdx_e.to(_F32)
    dyf = cdy_e.to(_F32)
    lx = dxf * iv
    ly = dyf * iv
    c0, c1_, c2_ = carc == 0, carc == 1, carc == 2
    a = _select([c0, c1_, c2_], [lx, ly, -lx], -ly)
    b = _select([c0, c1_, c2_], [ly, -lx, -ly], lx)
    # support differences are exact integers in f32
    wdx = sup_x[:, 1] - sup_x[:, 3]
    wdy = sup_y[:, 1] - sup_y[:, 3]
    rwidth = _dot2(wdx, a, wdy, b)
    hdx = sup_x[:, 2] - sup_x[:, 0]
    hdy = sup_y[:, 2] - sup_y[:, 0]
    rheight = _dot2(hdy, a, -hdx, b)
    area = rwidth * rheight
    area = torch.where(cvalid, area, torch.full_like(area, inf))

    # winner among candidates: minimal f32 area, ties to the LAST visited
    # (cv2's replace-on-<=)
    min_area = area.amin(dim=1, keepdim=True)
    later_cnt = ((((ctan[:, :, None] > ctan[:, None, :]) |
                   ((ctan[:, :, None] == ctan[:, None, :]) &
                    (carc[:, :, None] > carc[:, None, :]))) &
                  cvalid[:, None, :]).to(_I32).sum(dim=2, dtype=_I32))
    tie_rank = torch.where(area == min_area, later_cnt,
                           torch.full_like(later_cnt, -1))
    win = torch.argmax(tie_rank, dim=1)[:, None]                # (D, 1)

    def g(arr):
        return _pick(arr, win)[:, 0]

    def g4(arr):
        return torch.gather(arr, 2, win[:, None, :].expand(d, 4, 1))[
            :, :, 0] + 0.0

    wa = g(a)
    wb = g(b)
    wsx = g4(sup_x)
    wsy = g4(sup_y)
    wwidth = g(rwidth)
    wheight = g(rheight)

    # absolute support coordinates (cv2 computes on absolute hull points)
    x0f = x0.to(_F32)
    y0f = min_y.to(_F32)
    lxx = wsx[:, 3] + x0f
    lyy = wsy[:, 3] + y0f
    bxx = wsx[:, 0] + x0f
    byy = wsy[:, 0] + y0f
    nb = -wb
    cc1 = _dot2(lxx, wa, lyy, wb)
    cc2 = _dot2(bxx, nb, byy, wa)
    det = _dot2(wa, wa, -nb, wb)
    idet = 1.0 / det
    px = _dot2(cc1, wa, -cc2, wb) * idet
    py = _dot2(cc2, wa, -cc1, nb) * idet
    osx = _dot2(wa, wwidth, nb, wheight)     # o1x + o2x
    osy = _dot2(wb, wwidth, wa, wheight)     # o1y + o2y
    cal_cx = osx * 0.5 + px
    cal_cy = osy * 0.5 + py

    cx = torch.where(n <= 2, deg_cx, cal_cx)
    cy = torch.where(n <= 2, deg_cy, cal_cy)
    ok = (valid_any & contiguous & w_ok & n_ok & (n_in_band <= c) &
          vlen_ok.all(dim=1))
    return cx, cy, ok
