"""Per-component stats, hull edges and the exact minimum-area rectangle.

Counterpart of the run-table path of ``ysmr_tpu/ops/labeling.py``:
``component_stats_runs`` -> ``_stats_tail_from_tables`` ->
``_hull_edge_data`` -> ``min_area_rect`` (the integer edge-vector branch,
``_min_area_rect_exact``). The JAX module's docstring sets out why the
per-row x extremes span the convex hull and why the rectangle is exact.

Differences from the JAX module, all of representation:

- Functions take a whole batch: the run tables are (T, R) and the
  per-component tables (T*D, ...), components of every frame flattened
  into the leading axis (the JAX pipeline ``vmap``s one frame at a time).
- ``.at[idx].min/max(mode='drop')`` onto deliberately out-of-range indices
  becomes ``scatter_reduce_`` into a buffer whose last slot is a dump
  that is never read.
- The slope matrix of ``_hull_edge_data`` and the projection sweep of
  ``_min_area_rect_exact`` are the plain versions of the kernels
  ``csrc/hull.cu`` and ``csrc/sweep.cu`` (wrappers ``ops/hull.py`` and
  ``ops/sweep.py``); they run over chunks of the non-empty components so
  the (D, R, R) and (D, K, P) tensors stay small at dense capacities.
- ``arctan2`` runs in float64 and rounds to float32, so the CPU and CUDA
  give the same bits (library float32 ``atan2`` differs by an ulp).

Not ported: the float angle sweep of ``min_area_rect`` (every production
caller passes integer edge vectors) and the pixel-table and image paths.
"""

import math

import numpy as np
import torch

from ysmr_tpu_torch.ops import ds

_I32 = torch.int32
_F32 = torch.float32
#: "no value" for int32 row tables (matches the JAX module's 1 << 30)
BIG_I = 1 << 30
#: "no value" for float32 extents and slopes
BIG_F = 3.0e38

# caliper-edge length bound for the cv2-center inv-sqrt table: components
# with hull edges longer than this in x fall back to exact centers
_CV2_CENTER_MAX_EDGE_W = 256

#: float32(180 / pi), the constant of jnp.degrees
_RAD_TO_DEG = float(np.float32(180.0 / math.pi))

#: pair elements per chunk of the plain (D, R, R) / (D, K, P) tensors
_CHUNK_ELEMS = 1 << 22


def _chunks(n, per_item):
    step = max(1, _CHUNK_ELEMS // max(per_item, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def component_stats_runs(s_start, s_len, s_comp, *, w, h, max_det, max_bh,
                         cv2_centers=False):
    """Component stats straight from component-sorted run tables.

    :param s_start, s_len: (T, R) int32 component-sorted run geometry
        (len 0 = padding)
    :param s_comp: (T, R) int32 component id per run (ids contiguous in
        table order; -1 = none)
    :return: the ``_stats_tail_from_tables`` dict over (T*max_det, ...)
    """
    t, r = s_start.shape
    dev = s_start.device
    valid = s_len > 0
    rows = torch.div(s_start, w, rounding_mode='floor')
    x0 = s_start - rows * w
    x1 = x0 + s_len - 1
    iota = torch.arange(r, dtype=_I32, device=dev)[None, :]
    prev_comp = torch.roll(s_comp, 1, dims=1)
    prev_valid = torch.roll(valid, 1, dims=1)
    comp_start = valid & ((iota == 0) | (s_comp != prev_comp) | ~prev_valid)
    # per-run component min-y (= the row of the component's first run):
    # ordinal-encoded cummax fill-forward
    ybits = max(int(h) - 1, 1).bit_length()
    cnum = torch.cumsum(comp_start.to(_I32), dim=1, dtype=_I32)
    enc = torch.where(comp_start, cnum * (1 << ybits) + rows,
                      torch.full_like(rows, -1))
    y0 = torch.cummax(enc, dim=1).values & ((1 << ybits) - 1)
    rel_y = torch.clamp(rows - y0, 0, max_bh - 1)
    nrow = max_det * max_bh + 1      # the last slot is the dump
    ok = valid & (s_comp >= 0) & (s_comp < max_det)
    idx = torch.where(ok, s_comp * max_bh + rel_y,
                      torch.full_like(rows, nrow - 1))
    idx = (idx + torch.arange(t, dtype=_I32, device=dev)[:, None] * nrow)
    idx = idx.reshape(-1).long()

    def scatter(src, reduce, init):
        buf = torch.full((t * nrow,), init, dtype=_I32, device=dev)
        buf.scatter_reduce_(0, idx, src.reshape(-1), reduce,
                            include_self=True)
        return buf.view(t, nrow)[:, :nrow - 1].reshape(t * max_det, max_bh)

    row_min_x = scatter(x0, 'amin', BIG_I)
    row_max_x = scatter(x1, 'amax', -BIG_I)
    y_tab = scatter(rows, 'amin', BIG_I)
    row_valid = row_min_x < BIG_I
    min_y = torch.where(row_valid[:, 0], y_tab[:, 0],
                        torch.full_like(y_tab[:, 0], BIG_I))
    return _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y,
                                   max_bh=max_bh, cv2_centers=cv2_centers)


def _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y, *,
                            max_bh, cv2_centers=False):
    """Row-extreme tables (D, R) -> count, candidate points and the exact
    hull-edge candidates; with ``cv2_centers`` also the raw tables that
    ``ops/cv2_centers.py`` reads."""
    abs_y = (min_y[:, None] + torch.arange(max_bh, dtype=_I32,
                                           device=min_y.device)[None, :])
    count = torch.where(row_valid, row_max_x - row_min_x + 1,
                        torch.zeros_like(row_min_x)).sum(dim=1, dtype=_I32)
    pts_x = torch.cat([row_min_x, row_max_x], dim=1).to(_F32)
    pts_y = torch.cat([abs_y, abs_y], dim=1).to(_F32)
    pts = torch.stack([pts_x, pts_y], dim=-1)       # (D, 2*R, 2)
    pts_valid = torch.cat([row_valid, row_valid], dim=1)
    edge_dx, edge_dy, edge_angles, edge_valid, corner_l, corner_r = \
        _hull_edge_data(row_min_x, row_max_x, row_valid, abs_y.contiguous())
    out = {'count': count, 'min_y': min_y, 'points': pts,
           'points_valid': pts_valid, 'edge_dx': edge_dx,
           'edge_dy': edge_dy, 'edge_angles': edge_angles,
           'edge_valid': edge_valid}
    if cv2_centers:
        out.update(row_min_x=row_min_x, row_max_x=row_max_x,
                   row_valid=row_valid, corner_l=corner_l,
                   corner_r=corner_r)
    return out


def _fold_edge_vector(dx, dy):
    """Fold an integer edge vector to the quadrant dx > 0, dy >= 0 (the
    [0, 90) direction of its rectangle orientation class); a zero vector
    folds to (1, 0)."""
    neg = (dy < 0) | ((dy == 0) & (dx < 0))
    dx = torch.where(neg, -dx, dx)
    dy = torch.where(neg, -dy, dy)
    rot = (dx <= 0) & (dy > 0)           # rotate -90: (dx, dy) <- (dy, -dx)
    dx, dy = torch.where(rot, dy, dx), torch.where(rot, -dx, dy)
    dx = torch.where((dx == 0) & (dy == 0), torch.ones_like(dx), dx)
    return dx, dy


def _atan2_f32(y, x):
    """float32 atan2 through float64, the same bits on every device."""
    return torch.atan2(y.double(), x.double()).to(_F32)


def _edge_vector_finish(dx_e, dy_e, has_edge, r):
    """Fold each chain's outgoing edge vector and derive its angle; slot 0
    doubles as the always-present horizontal candidate."""
    iota = torch.arange(r - 1, device=dx_e.device)
    dx, dy = _fold_edge_vector(dx_e[:, :r - 1], dy_e[:, :r - 1])
    keep = has_edge[:, :r - 1]
    dx = torch.where(keep, dx, torch.ones_like(dx))
    dy = torch.where(keep, dy, torch.zeros_like(dy))
    ang = torch.where(keep, _atan2_f32(dy, dx), torch.zeros_like(dx))
    valid = keep | (iota[None, :] == 0)
    return dx, dy, ang, valid


def hull_edge_vectors_plain(row_min_x, row_max_x, row_valid, abs_y):
    """Plain version of the ``csrc/hull.cu`` kernel: the slope-matrix
    closed form of ``ysmr_tpu/ops/labeling.py::_hull_edge_data``
    (:794-833) before the angle finishing.

    Point i of the left chain (x minima) is a chain vertex iff the maximum
    slope dx/dy into it from the rows above does not exceed the minimum
    slope out of it to the rows below; its outgoing edge goes to the
    farthest row attaining that minimum. The right chain (x maxima)
    negates the slopes. Slopes are correctly rounded float32 quotients of
    exact integer differences.

    :param row_min_x, row_max_x, abs_y: (D, R) int32; row_valid (D, R) bool
    :return: (dx_l, dy_l, edge_l, dx_r, dy_r, edge_r, corner_l, corner_r):
        (D, R) float32 outgoing edge vectors (0 where the edge flag is
        False), the edge flags and the strict-corner flags (bool)
    """
    d, r = row_min_x.shape
    dev = row_min_x.device
    outs = [torch.zeros((d, r), dtype=_F32, device=dev) for _ in range(2)] + \
        [torch.zeros((d, r), dtype=torch.bool, device=dev)] + \
        [torch.zeros((d, r), dtype=_F32, device=dev) for _ in range(2)] + \
        [torch.zeros((d, r), dtype=torch.bool, device=dev) for _ in range(3)]
    act = torch.nonzero(row_valid.any(dim=1)).flatten()
    iota = torch.arange(r, device=dev)
    upper = iota[None, :] > iota[:, None]                   # j > i
    for s, e in _chunks(act.numel(), r * r):
        sel = act[s:e]
        v = row_valid[sel]
        ys = abs_y[sel].to(_F32)
        pair = v[:, :, None] & v[:, None, :] & upper[None]  # (d, i, j) i<j
        dy = ys[:, None, :] - ys[:, :, None]                # y_j - y_i
        dy_safe = torch.where(pair, dy, torch.ones_like(dy))
        chunk_out = []
        for xs, sgn in ((row_min_x, 1.0), (row_max_x, -1.0)):
            x = xs[sel].to(_F32)
            dxm = x[:, None, :] - x[:, :, None]
            slope = torch.where(pair, sgn * (dxm / dy_safe),
                                torch.full_like(dxm, BIG_F))
            out_min = slope.amin(dim=2)                     # over j > i
            in_max = torch.where(slope < BIG_F, slope,
                                 torch.full_like(slope, -BIG_F)).amax(dim=1)
            has_edge = v & (out_min >= in_max) & (out_min < BIG_F)
            strict = v & (out_min > in_max)
            # the farthest j attaining the minimum slope
            att = pair & (slope <= out_min[:, :, None])
            j_star = torch.where(att, iota[None, None, :],
                                 torch.full_like(iota, -1)[None, None, :])
            jc = j_star.amax(dim=2).clamp(0, r - 1)
            dx_e = torch.gather(x, 1, jc) - x
            dy_e = torch.gather(ys, 1, jc) - ys
            zero = torch.zeros_like(dx_e)
            chunk_out.append((torch.where(has_edge, dx_e, zero),
                              torch.where(has_edge, dy_e, zero), has_edge,
                              strict))
        (dxl, dyl, el, cl), (dxr, dyr, er, cr) = chunk_out
        for o, val in zip(outs, (dxl, dyl, el, dxr, dyr, er, cl, cr)):
            o[sel] = val
    return tuple(outs)


def _hull_edge_data(row_min_x, row_max_x, row_valid, abs_y):
    """Exact hull-edge candidate vectors and angles of both chains.

    The slopes come from ``ops/hull.py::hull_edge_vectors`` (the CUDA
    kernel on a CUDA tensor, ``hull_edge_vectors_plain`` on a CPU one);
    the angle finishing runs here, as in the JAX module.

    :return: (dx, dy, angles, valid, corner_l, corner_r): the first four
        (D, 2*(R-1)) folded integer edge vectors, their float32 angles in
        [0, pi/2) and validity; the corners (D, R) strict chain-corner
        masks (consumed by ops/cv2_centers)
    """
    from ysmr_tpu_torch.ops.hull import hull_edge_vectors
    r = row_min_x.shape[1]
    dxl, dyl, el, dxr, dyr, er, cl, cr = hull_edge_vectors(
        row_min_x, row_max_x, row_valid, abs_y)
    lx, ly, la, lv = _edge_vector_finish(dxl, dyl, el, r)
    rx, ry, ra, rv = _edge_vector_finish(dxr, dyr, er, r)
    return (torch.cat([lx, rx], dim=1), torch.cat([ly, ry], dim=1),
            torch.cat([la, ra], dim=1), torch.cat([lv, rv], dim=1), cl, cr)


def sweep_extents_plain(pts, valid, dx, dy):
    """Plain version of the ``csrc/sweep.cu`` kernel
    (``ysmr_tpu/ops/labeling.py:911-922``): per component and candidate
    direction (dx, dy), the min and max of ``u = x*dx + y*dy`` and
    ``v = y*dx - x*dy`` over the valid points; (+big, -big) when a
    component has no valid point. With integer points and directions every
    product and sum is an exact float32 integer.

    :param pts: (D, P, 2) float32; valid (D, P) bool; dx, dy (D, K) float32
    :return: (min_u, max_u, min_v, max_v), each (D, K) float32
    """
    d, p = valid.shape
    k = dx.shape[1]
    dev = pts.device
    lo = torch.full((d, k), BIG_F, dtype=_F32, device=dev)
    outs = [lo, torch.full_like(lo, -BIG_F), lo.clone(),
            torch.full_like(lo, -BIG_F)]
    act = torch.nonzero(valid.any(dim=1)).flatten()
    for s, e in _chunks(act.numel(), k * p):
        sel = act[s:e]
        dxb = dx[sel][:, :, None]
        dyb = dy[sel][:, :, None]
        px = pts[sel][..., 0][:, None, :]
        py = pts[sel][..., 1][:, None, :]
        pu = px * dxb + py * dyb
        pv = py * dxb - px * dyb
        vm = valid[sel][:, None, :]
        big = torch.full_like(pu, BIG_F)
        outs[0][sel] = torch.where(vm, pu, big).amin(dim=-1)
        outs[1][sel] = torch.where(vm, pu, -big).amax(dim=-1)
        outs[2][sel] = torch.where(vm, pv, big).amin(dim=-1)
        outs[3][sel] = torch.where(vm, pv, -big).amax(dim=-1)
    return tuple(outs)


def _ds_less(ah, al, bh, bl):
    return (bh < ah) | ((bh == ah) & (bl < al))


def min_area_rect(pts, valid, edge_angles, edge_valid, edge_dx, edge_dy):
    """Exact minimum-area rectangle over integer hull-edge candidates
    (``ysmr_tpu/ops/labeling.py::_min_area_rect_exact``).

    The minimal rectangle has a side collinear with a hull edge, and the
    projections onto integer edge vectors are exact float32 integers, so
    the scaled areas are exact double-single products compared exactly;
    equal areas resolve to the largest-angle candidate (cv2's calipers
    visit edges in increasing rotation and replace on <=).

    :param pts: (D, P, 2) float32 candidate points; valid (D, P) bool
    :param edge_*: (D, K) candidate edge vectors, angles and validity
    :return: dict of (D,) float32 cx, cy, w, h, angle_deg (cv2's classic
        convention: degrees in [-90, 0), w along the reported angle)
    """
    from ysmr_tpu_torch.ops.sweep import sweep_extents
    d = edge_dx.shape[0]
    dev = edge_dx.device
    # the hull's closing edges (top/bottom row) are horizontal and are not
    # emitted by the left/right chains: append an always-valid (1, 0)
    one = torch.ones((d, 1), dtype=edge_dx.dtype, device=dev)
    edge_dx = torch.cat([edge_dx, one], dim=1)
    edge_dy = torch.cat([edge_dy, one * 0.0], dim=1)
    edge_angles = torch.cat([edge_angles, one * 0.0], dim=1)
    edge_valid = torch.cat(
        [edge_valid, torch.ones((d, 1), dtype=torch.bool, device=dev)], dim=1)
    k = edge_dx.shape[1]
    min_u, max_u, min_v, max_v = sweep_extents(
        pts.contiguous(), valid.contiguous(), edge_dx.contiguous(),
        edge_dy.contiguous())
    # all-invalid components give inverted +-big extents; clamp to keep the
    # arithmetic NaN-free (their outputs are masked by det_valid later)
    du = torch.clamp(max_u - min_u, min=0.0)
    dv = torch.clamp(max_v - min_v, min=0.0)
    l2 = edge_dx * edge_dx + edge_dy * edge_dy
    a_h, a_l = ds.two_prod(du, dv)
    area_h, area_l = ds.div_by_f32(a_h, a_l, l2)
    area_h = torch.where(edge_valid, area_h, torch.full_like(area_h, BIG_F))
    area_l = torch.where(edge_valid, area_l, torch.zeros_like(area_l))

    # double-single minimum over candidates (the JAX module's pairwise
    # halving, so ties among equal pairs resolve the same way)
    mh, ml = area_h, area_l
    n = k
    while n > 1:
        half = n // 2
        if n % 2:
            lt = _ds_less(mh[:, :1], ml[:, :1], mh[:, n - 1:n],
                          ml[:, n - 1:n])
            mh = torch.cat([torch.where(lt, mh[:, n - 1:n], mh[:, :1]),
                            mh[:, 1:]], dim=1)
            ml = torch.cat([torch.where(lt, ml[:, n - 1:n], ml[:, :1]),
                            ml[:, 1:]], dim=1)
        lt = _ds_less(mh[:, :half], ml[:, :half], mh[:, half:2 * half],
                      ml[:, half:2 * half])
        mh, ml = (torch.where(lt, mh[:, half:2 * half], mh[:, :half]),
                  torch.where(lt, ml[:, half:2 * half], ml[:, :half]))
        n = half
    # ties: double-single noise is ~1e-13 relative while distinct rational
    # areas differ by >= 1/(l2_i * l2_j)
    diff_h, _ = ds.sub(area_h, area_l, mh, ml)
    tie = edge_valid & (diff_h <= mh * 1e-9 + 1e-9)
    ebest = torch.argmax(torch.where(tie, edge_angles,
                                     torch.full_like(edge_angles, -1.0)),
                         dim=1)[:, None]

    def pick(a):
        return torch.gather(a, 1, ebest)[:, 0]

    bdx, bdy, bl2 = pick(edge_dx), pick(edge_dy), pick(l2)
    bl = torch.sqrt(bl2.double()).to(_F32)   # correctly rounded, any device
    w_side = pick(du) / bl
    h_side = pick(dv) / bl
    cu2 = pick(min_u) + pick(max_u)   # 2 * scaled centre
    cv2_ = pick(min_v) + pick(max_v)
    t1h, t1l = ds.two_prod(cu2, bdx)
    t2h, t2l = ds.two_prod(cv2_, bdy)
    nxh, nxl = ds.sub(t1h, t1l, t2h, t2l)
    t3h, t3l = ds.two_prod(cu2, bdy)
    t4h, t4l = ds.two_prod(cv2_, bdx)
    nyh, nyl = ds.add(t3h, t3l, t4h, t4l)
    inv = 1.0 / (2.0 * bl2)
    cx = nxh * inv + nxl * inv
    cy = nyh * inv + nyl * inv
    # jnp.degrees(angle) - 90: one multiply by the float32 constant 180/pi,
    # which XLA contracts with the subtraction into one fma
    ang = pick(edge_angles)
    angle_deg = ds.fma_f32(ang, torch.full_like(ang, _RAD_TO_DEG),
                           torch.full_like(ang, -90.0))
    return {'cx': cx, 'cy': cy, 'w': h_side, 'h': w_side,
            'angle_deg': angle_deg}
