"""The stats tail on the row tables in the PyTorch port:
``ops/labeling.py::_stats_tail_from_tables`` and ``rect_from_tables``,
the hull's table entry (``ops/hull.py``, kernel ``csrc/hull.cu``: abs_y
formed, count written) and the sweep over the hull's strict corners
(``ops/sweep.py``, kernel ``csrc/sweep.cu``, the direction (1, 0)
implicit).

- The corner-restricted sweep (``sweep_tables_plain``) equals
  ``sweep_extents_plain`` over every valid point (``candidate_points``,
  ``ysmr_tpu``'s points), bit for bit, along the finished edge candidates
  and along random integer directions, on seeded random tables and on
  edge cases: one row, one column, all rows collinear, gaps in the rows,
  empty components (min_y = BIG_I), a component filling R = max_bh rows.
- ``csrc/sweep.cu``'s design as a numpy float32 emulation (a warp per
  component, each lane's directions and passes, 32-row chunks, the
  corner ballot taken in order, the implicit (1, 0)) equals the plain
  version at K = 1 to 191.
- The table route against ``ysmr_tpu``'s ``_stats_tail_from_tables`` and
  ``_min_area_rect_exact`` on the same tables: count, min_y and the
  rect's W, H, angle and centre bit for bit.
- The hull's table entry on CPU tensors is ``hull_edge_vectors_plain``
  with abs_y = min_y + row, and count the numpy row-span sum.
- ``cuda``-marked twins hold the kernels bit-equal to their plain
  versions on the card and the table route's bits to the CPU's, with no
  candidate point built there (they skip here).

Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_hull import _random_tables
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import rect
from ysmr_tpu_torch.ops.hull import hull_edge_vectors
from ysmr_tpu_torch.ops.sweep import sweep_extents

torch.set_num_threads(1)

F32 = np.float32
BIG = lb.BIG_I


def _rows(blobs, r):
    """Row tables (D, R) of components given as lists of (row, x0, x1)
    (None: no row); min_y is the first row's y plus 37."""
    d = len(blobs)
    lo = np.full((d, r), BIG, np.int32)
    hi = np.full((d, r), -BIG, np.int32)
    valid = np.zeros((d, r), bool)
    min_y = np.full(d, BIG, np.int32)
    for i, rows in enumerate(blobs):
        if not rows:
            continue
        min_y[i] = 37 + i
        for row, x0, x1 in rows:
            lo[i, row], hi[i, row], valid[i, row] = x0, x1, True
    return lo, hi, valid, min_y


def edge_tables(r=48):
    """The edge cases at R = max_bh = 48: no row, one pixel, one row, one
    column, collinear rows (a line and a slanted band), rows with gaps, a
    rod filling all R rows, a wedge whose corners are few."""
    blobs = [None,
             [(0, 40, 40)],
             [(0, 30, 44)],
             [(i, 50, 50) for i in range(12)],
             [(i, 100 + 2 * i, 100 + 2 * i) for i in range(20)],
             [(i, 100 + 3 * i, 104 + 3 * i) for i in range(r)],
             [(i, 60 + (i % 3), 70 - (i % 5)) for i in range(0, 30, 3)],
             [(i, 200 + i // 2, 205 + i // 2) for i in range(r)],
             [(i, 300 - i, 300 + i) for i in range(25)],
             [(0, 7, 9), (r - 1, 1200, 1220)]]
    return _rows(blobs, r)


def random_tables(seed, d, r, holes=False):
    """``test_pallas_hull``'s seeded tables (15% empty, min_y = 2^30 on
    those), with ``holes`` valid rows that are no prefix."""
    rng = np.random.default_rng(seed)
    lo, hi, valid, abs_y = _random_tables(rng, d, r)
    if holes:
        valid = valid & (rng.random(valid.shape) < 0.6)
        lo = np.where(valid, lo, BIG).astype(np.int32)
        hi = np.where(valid, hi, -BIG).astype(np.int32)
    return lo, hi, valid, abs_y[:, 0].copy()


CASES = {'edge R=48': lambda: edge_tables(48),
         'random R=48': lambda: random_tables(1, 600, 48),
         'random R=16 holes': lambda: random_tables(2, 400, 16, True),
         'random R=64 holes': lambda: random_tables(3, 300, 64, True),
         'random R=96': lambda: random_tables(4, 200, 96),
         'random R=1': lambda: random_tables(5, 50, 1),
         'random R=2': lambda: random_tables(6, 80, 2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tail(case):
    """The case's tables and the plain stats tail over them."""
    tabs = [_t(a) for a in CASES[case]()]
    return tabs, lb._stats_tail_from_tables(*tabs)


def random_dirs(seed, d, k):
    """(D, K - 1) integer directions as the edge finish folds them (dx >=
    1, dy >= 0)."""
    rng = np.random.default_rng(seed)
    return (_t(rng.integers(1, 60, (d, k - 1)).astype(F32)),
            _t(rng.integers(0, 48, (d, k - 1)).astype(F32)))


@pytest.mark.parametrize('dirs', ['edges', 'random'])
@pytest.mark.parametrize('case', list(CASES))
def test_corner_sweep_equals_full_sweep(case, dirs):
    tabs, t = tail(case)
    d, r = tabs[0].shape
    edx, edy = t['edge_dx'], t['edge_dy']
    if dirs == 'random':
        edx, edy = random_dirs(r, d, 2 * r - 1)
    got = lb.sweep_tables_plain(*tabs, t['corner_l'], t['corner_r'], edx,
                                edy)
    pts, valid = lb.candidate_points(*tabs)
    want = lb.sweep_extents_plain(pts, valid, *lb._with_axis(edx, edy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.numpy().view(np.int32))
    # the corners are a strict subset of the valid points somewhere
    corners = torch.cat([t['corner_l'], t['corner_r']], 1)
    assert not (corners & ~valid).any()
    if r > 2:
        assert int(corners.sum()) < int(valid.sum())


def sweep_emulated(row_min_x, row_max_x, row_valid, min_y, corner_l,
                   corner_r, dx, dy):
    """csrc/sweep.cu in numpy float32, one warp (axis 1: 32 lanes) per
    component (axis 0): a component with no valid row writes +-big; else
    lane l holds directions e0 + l + 32 i (i < kDirs, (1, 0) formed for e
    = K - 1), and for each 32-row chunk the corner rows are taken in
    ascending order (the ballot's bits), the left point before the right,
    each folded into every lane's directions."""
    d, r = row_min_x.shape
    k = dx.shape[1] + 1
    kdirs = 1 if k <= 32 else 2 if k <= 64 else 3 if k <= 96 else 4
    big = F32(3.0e38)
    outs = [np.full((d, k), s * big, F32) for s in (1, -1, 1, -1)]
    occupied = row_valid.any(1)
    lane = np.arange(32)
    for e0 in range(0, k, 32 * kdirs):
        e = e0 + lane[:, None] + 32 * np.arange(kdirs)[None, :]
        ec = np.clip(e, 0, max(k - 2, 0))
        axis = e >= k - 1
        shape = (d,) + e.shape
        ex = np.broadcast_to(np.where(axis, F32(1), dx[:, ec] if k > 1
                                      else F32(0)), shape)
        ey = np.broadcast_to(np.where(axis, F32(0), dy[:, ec] if k > 1
                                      else F32(0)), shape)
        acc = [np.full(ex.shape, s * big, F32) for s in (1, -1, 1, -1)]
        for j0 in range(0, r, 32):
            j = j0 + lane
            jc = np.minimum(j, r - 1)
            v = (j < r)[None, :] & row_valid[:, jc]
            cl, cr = v & corner_l[:, jc], v & corner_r[:, jc]
            xl = np.where(cl, row_min_x[:, jc], 0)
            xr = np.where(cr, row_max_x[:, jc], 0)
            for src in range(32):
                y = np.where(occupied, min_y.astype(np.int64) + j0 + src,
                             0).astype(F32)[:, None, None]
                for has, x in ((cl[:, src], xl[:, src]),
                               (cr[:, src], xr[:, src])):
                    if not has.any():
                        continue
                    x = x.astype(F32)[:, None, None]
                    u = x * ex + y * ey
                    w = y * ex - x * ey
                    m = has[:, None, None]
                    acc = [np.where(m, f(a, val), a) for a, f, val in zip(
                        acc, (np.minimum, np.maximum) * 2, (u, u, w, w))]
        for li in range(32):
            for i in range(kdirs):
                if e[li, i] < k:
                    for o, a in zip(outs, acc):
                        o[occupied, e[li, i]] = a[occupied, li, i]
    return outs


@pytest.mark.parametrize('case', list(CASES))
def test_sweep_warp_design_bit_equal_to_plain(case):
    """K = 2 R - 1: 1, 3, 31, 95, 127 and 191 (one to four directions a
    lane, two passes at 191), the pipeline's candidates."""
    tabs, t = tail(case)
    args = [a.numpy() for a in tabs] + [
        t[k].numpy() for k in ('corner_l', 'corner_r', 'edge_dx', 'edge_dy')]
    want = lb.sweep_tables_plain(*(t[k] for k in lb.SWEEP_KEYS))
    for g, w in zip(sweep_emulated(*args), want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


@pytest.mark.parametrize('k', [2, 32, 33, 64, 65, 129])
def test_sweep_warp_design_direction_splits(k):
    """Random directions at K splitting the lanes' directions unevenly (K
    - 1 = 31 is the last K of one direction a lane; 129 takes a second
    pass of one lane's direction)."""
    tabs, t = tail('random R=48')
    edx, edy = random_dirs(k, tabs[0].shape[0], k)
    args = tabs + [t['corner_l'], t['corner_r'], edx, edy]
    want = lb.sweep_tables_plain(*args)
    for g, w in zip(sweep_emulated(*(a.numpy() for a in args)), want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


@pytest.mark.parametrize('case', list(CASES))
def test_table_route_matches_jax(case):
    """The port's tail and rect from the tables against ``ysmr_tpu``'s
    ``_stats_tail_from_tables`` and ``_min_area_rect_exact`` (XLA, the
    points and the appended candidate built), bit for bit."""
    tabs, t = tail(case)
    assert 'points' not in t
    got = lb.rect_from_tables(t)
    d, r = tabs[0].shape
    ref = jlb._stats_tail_from_tables(
        *(jnp.asarray(a.numpy()) for a in tabs), max_det=d, max_bh=r,
        use_pallas_hull=False)
    jrect = jax.jit(jlb._min_area_rect_exact,
                    static_argnames=('use_pallas_sweep',))(
        ref['points'], ref['points_valid'], ref['edge_dx'], ref['edge_dy'],
        ref['edge_angles'], ref['edge_valid'], use_pallas_sweep=False)
    np.testing.assert_array_equal(t['count'].numpy(),
                                  np.asarray(ref['count']))
    np.testing.assert_array_equal(t['min_y'].numpy(),
                                  np.asarray(ref['min_y']))
    ok = np.asarray(ref['count']) > 0
    assert ok.any()
    for key in ('cx', 'cy', 'w', 'h', 'angle_deg'):
        np.testing.assert_array_equal(
            got[key].numpy()[ok].view(np.int32),
            np.asarray(jrect[key])[ok].view(np.int32), err_msg=key)


@pytest.mark.parametrize('case', list(CASES))
def test_hull_table_entry_is_plain_with_abs_y(case):
    lo, hi, valid, min_y = CASES[case]()
    r = lo.shape[1]
    got = hull_edge_vectors(*(_t(a) for a in (lo, hi, valid, min_y)))
    abs_y = (min_y[:, None].astype(np.int64) + np.arange(r)).astype(np.int32)
    want = lb.hull_edge_vectors_plain(*(_t(a) for a in (lo, hi, valid,
                                                          abs_y)))
    assert len(got) == 9 and hull_edge_vectors.launches == 0
    for g, w in zip(got[:8], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_array_equal(
        got[8].numpy(), np.where(valid, hi - lo + 1, 0).sum(1))
    assert got[8].dtype == torch.int32


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    tabs, t = tail('edge R=48')
    args = [t[k] for k in lb.SWEEP_KEYS]
    for wrapper, plain, a in ((sweep_extents, lb.sweep_tables_plain, args),
                              (hull_edge_vectors, lb.hull_tables_plain,
                               tabs)):
        before = wrapper.launches
        for g, w in zip(wrapper(*a), plain(*a)):
            assert torch.equal(g, w)
        assert wrapper.launches == before
        with pytest.raises(ValueError, match='unsupported device'):
            wrapper(*(x.to('meta') for x in a))


# ------------------------------------------------------- on the card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dirs', ['edges', 'random'])
@pytest.mark.parametrize('case', list(CASES))
def test_sweep_kernel_matches_plain_on_cuda(case, dirs):
    """The sweep kernel against its plain version on the card, bit for
    bit, one launch a call; D no multiple of a block's eight warps in most
    cases."""
    dev = _cuda_or_skip()
    tabs, t = tail(case)
    args = [t[k] for k in lb.SWEEP_KEYS]
    if dirs == 'random':
        args[6:] = random_dirs(7, *args[6].shape[:1], 2 * tabs[0].shape[1]
                               - 1)
    want = lb.sweep_tables_plain(*args)
    before = sweep_extents.launches
    got = sweep_extents(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert sweep_extents.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(CASES))
def test_table_route_on_cuda_equals_cpu(case):
    """The tail and the rect from the tables on the card: every output's
    bits those of the CPU route, each kernel launched once, no candidate
    point built on the card."""
    dev = _cuda_or_skip()
    tabs, t = tail(case)
    want = lb.rect_from_tables(t)
    counted = (hull_edge_vectors, rect.edge_finish, sweep_extents,
               rect.rect_select)
    before = [k.launches for k in counted]
    points = lb.candidate_points.cuda_calls
    gt = lb._stats_tail_from_tables(*(a.to(dev) for a in tabs))
    got = lb.rect_from_tables(gt)
    torch.cuda.synchronize()
    assert lb.candidate_points.cuda_calls == points
    launched = [k.launches - b for k, b in zip(counted, before)]
    assert launched == [1, int(tabs[0].shape[1] > 1), 1, 1]
    for key in t:
        assert torch.equal(gt[key].cpu(), t[key]), key
    for key in want:
        assert torch.equal(got[key].cpu().view(torch.int32),
                           want[key].view(torch.int32)), key
