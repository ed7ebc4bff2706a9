"""Device stats, hull edges and the exact rect of the PyTorch port
(ysmr_tpu_torch/ops/labeling.py, the kernel wrappers ops/hull.py and
ops/sweep.py, and the device-rect branch of pipeline/detect_pixels.py)
against the JAX package on the same numpy inputs. The port's stats tail
builds no candidate points; ``lb.candidate_points`` gives them from its
tables, and those are held to ``ysmr_tpu``'s.

Tolerances and why:
- integer tables, hull edge vectors and flags, sweep extents: bit-equal
  (both compute the same correctly rounded float32 quotients, and every
  projection is an exact float32 integer);
- edge angles: bit-equal (XLA:CPU's float32 atan2 is glibc's fdlibm
  ``atan2f``, which the port spells out in float32 operations);
- rect W/H and angle: bit-equal (the port forms XLA's contracted
  ``degrees(a) - 90`` fma exactly, ``ds.fma_f32``);
- rect centers: 1e-4 px, because XLA:CPU may contract the double-single
  center arithmetic into fmas that PyTorch does not form (measured equal
  on these inputs);
- cv2 centers: bit-equal (their arithmetic is written to be
  contraction-proof).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_hull import _random_tables
from ysmr_tpu import native as jnative
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu.ops import run_cc as jrcc
from ysmr_tpu.ops.pallas_hull import hull_edge_vectors as jhull_pallas
from ysmr_tpu.ops.pallas_sweep import sweep_extents as jsweep_pallas
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels as jdetect
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import run_cc as trcc
from ysmr_tpu_torch.ops.hull import HULL_MAX_SHARED_ROWS, hull_edge_vectors
from ysmr_tpu_torch.ops.sweep import sweep_extents
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels

torch.set_num_threads(1)

H, W, MAX_BH = 96, 128, 16


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def blob_wire(seed, t=3, f=4096, n=14):
    """Run wires of frames with rotated rods and ellipses (markers on the
    brighter half of the blobs), as the host threshold would give them."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((t, f), np.uint32)
    counts = np.zeros(t, np.int32)
    for k in range(t):
        img = np.zeros((H, W), np.uint8)
        for _ in range(n):
            c = (int(rng.integers(6, W - 6)), int(rng.integers(6, H - 6)))
            ax = (int(rng.integers(1, 7)), int(rng.integers(1, 4)))
            cv2.ellipse(img, c, ax, float(rng.uniform(0, 180)), 0, 360,
                        int(rng.choice([120, 220])), -1)
        yy, xx = np.nonzero(img)
        lin = (yy * W + xx).astype(np.uint32)
        mk = (img[yy, xx] > 150).astype(np.uint32)
        packed[k, :len(lin)] = lin | (mk << 31)
        counts[k] = len(lin)
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert jnative.encode_runs_numpy(packed, counts, runs, rcnt, w=W) > 0
    return runs[:, :1024], rcnt


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize('double_threshold', [True, False])
def test_sorted_run_tables_match_jax(double_threshold):
    runs, rcnt = blob_wire(1)
    ref = jrcc.run_cc_components(runs, rcnt, w=W,
                                 double_threshold=double_threshold)
    got = trcc.run_cc_components(_t(runs), _t(rcnt), w=W,
                                 double_threshold=double_threshold,
                                 sorted_runs=True)
    for key in ('s_start', 's_len', 's_comp', 'n_px', 'n_components'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


def _jax_stats(runs, rcnt, max_det):
    ref = jrcc.run_cc_components(runs, rcnt, w=W, double_threshold=True)
    n = np.asarray(ref['n_components'])
    s_comp = np.asarray(ref['s_comp'])
    comp_rev = np.where(s_comp >= 0, n[:, None] - 1 - s_comp, -1)
    per = [jlb.component_stats_runs(
        jnp.asarray(ref['s_start'][i]), jnp.asarray(ref['s_len'][i]),
        jnp.asarray(comp_rev[i]), w=W, h=H, max_det=max_det, max_bh=MAX_BH,
        cv2_centers=True) for i in range(runs.shape[0])]
    return {k: np.concatenate([np.asarray(p[k]) for p in per])
            for k in per[0]}, comp_rev, ref


def _with_points(tables):
    """The stats tail's dict with ``ysmr_tpu``'s candidate points added
    (``points``, ``points_valid``) from its row tables."""
    pts = lb.candidate_points(*(tables[k] for k in trcc.TABLE_KEYS))
    return dict(tables, points=pts[0], points_valid=pts[1])


@pytest.mark.parametrize('max_det', [64, 8])
def test_component_stats_runs_match_jax(max_det):
    """Row tables, counts, candidate points, hull edges and strict corners
    of every component (max_det 8 drops the components beyond it)."""
    runs, rcnt = blob_wire(2)
    ref, comp_rev, jcc = _jax_stats(runs, rcnt, max_det)
    got = _with_points(lb.component_stats_runs(
        _t(np.asarray(jcc['s_start'])), _t(np.asarray(jcc['s_len'])),
        _t(comp_rev.astype(np.int32)), w=W, h=H, max_det=max_det,
        max_bh=MAX_BH))
    for key in ('count', 'min_y', 'points', 'points_valid', 'edge_dx',
                'edge_dy', 'edge_valid', 'row_min_x', 'row_max_x',
                'row_valid', 'corner_l', 'corner_r'):
        np.testing.assert_array_equal(got[key].numpy(), ref[key],
                                      err_msg=key)
    assert _ulps(got['edge_angles'].numpy(), ref['edge_angles']).max() == 0
    assert (got['count'].numpy() > 0).sum() > 10


@pytest.mark.parametrize('d,r,seed', [(40, 12, 0), (64, 16, 1), (5, 8, 2)])
def test_hull_plain_bit_equal_to_xla_and_pallas(d, r, seed):
    """The plain version of the hull kernel against the XLA slope matrix
    (JAX labeling._hull_edge_data) and the Pallas kernel in interpret mode:
    edge vectors where the edge flag is set, all flags, and the finished
    candidates."""
    rng = np.random.default_rng(seed)
    row_min, row_max, valid, abs_y = _random_tables(rng, d, r)
    got = lb.hull_edge_vectors_plain(_t(row_min), _t(row_max), _t(valid),
                                     _t(abs_y))
    got = [g.numpy() for g in got]
    pal = [np.asarray(a) for a in jhull_pallas(
        jnp.asarray(row_min), jnp.asarray(row_max), jnp.asarray(valid),
        jnp.asarray(abs_y), interpret=True)]
    for i, (g, p) in enumerate(zip(got, pal)):
        if g.dtype == np.float32:
            flag = pal[2] if i < 2 else pal[5]
            p = np.where(flag, p, 0.0)
        np.testing.assert_array_equal(g, p, err_msg=str(i))
    ref = [np.asarray(a) for a in jlb._hull_edge_data(
        jnp.asarray(row_min), jnp.asarray(row_max), jnp.asarray(valid),
        jnp.asarray(abs_y))]
    out = [o.numpy() for o in lb._hull_edge_data(
        _t(row_min), _t(row_max), _t(valid), _t(abs_y[:, 0]))]
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(out[i], ref[i], err_msg=str(i))
    assert _ulps(out[2], ref[2]).max() == 0


def test_hull_collinear_runs_bit_equal():
    """Collinear chains: the farthest endpoint wins the tie in both."""
    r = 12
    valid = np.ones((3, r), bool)
    abs_y = np.tile(np.arange(r, dtype=np.int32), (3, 1)) + 7
    row_min = np.stack([
        np.full(r, 100, np.int32),
        (100 + 2 * np.arange(r)).astype(np.int32),
        np.where(np.arange(r) < 6, 100 + 3 * np.arange(r),
                 118 - np.arange(r)).astype(np.int32)])
    row_max = row_min + 5
    ref = [np.asarray(a) for a in jlb._hull_edge_data(
        jnp.asarray(row_min), jnp.asarray(row_max), jnp.asarray(valid),
        jnp.asarray(abs_y))]
    out = [o.numpy() for o in lb._hull_edge_data(
        _t(row_min), _t(row_max), _t(valid), _t(abs_y[:, 0]))]
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(out[i], ref[i], err_msg=str(i))


def _hull_emulated(row_min_x, row_max_x, row_valid, abs_y):
    """csrc/hull.cu's design in numpy float32, one warp (32 lanes,
    vectorised here) per component: the valid rows compacted in ascending
    order (the ballot); s = 32 // n lanes a row, lane k of a row looping
    over its rows q = k, k + s, ... with the kernel's arithmetic and its
    ``<=`` rule; then the shuffle tree that combines a row's lanes (the
    smaller minimum, on a tie the larger q; the larger maximum)."""
    f32 = np.float32
    big = f32(3.0e38)
    d, r = row_min_x.shape
    outs = [np.zeros((d, r), t) for t in (f32, f32, bool, f32, f32, bool,
                                          bool, bool)]
    lane = np.arange(32)
    for c in range(d):
        rows = np.flatnonzero(row_valid[c])
        n = len(rows)
        if n == 0:
            continue
        cy, cx = (abs_y[c, rows].astype(f32),
                  np.stack([row_min_x[c, rows], row_max_x[c, rows]]).astype(
                      f32))
        s = 32 // n if n <= 32 else 1
        per_pass, part = 32 // s, lane % s
        for p0 in range(0, n, per_pass):
            p = p0 + lane // s
            act = (lane < s * per_pass) & (p < n)
            pc = np.where(act, p, 0)
            # per chain: minimum, its q, maximum
            omin = np.full((2, 32), big)
            qmin = np.full((2, 32), -1)
            imax = np.full((2, 32), -big)
            with np.errstate(divide='ignore', invalid='ignore'):
                for q in range(0, n):
                    mine = act & (part == q % s)
                    dy = np.where(q == pc, f32(1), cy[q] - cy[pc])
                    cols = ((cx[0, q] - cx[0, pc]) / dy,
                            -(cx[1, q] - cx[1, pc]) / dy)
                    for k, col in enumerate(cols):
                        upd = mine & (q > pc) & (col <= omin[k])
                        omin[k] = np.where(upd, col, omin[k])
                        qmin[k] = np.where(upd, q, qmin[k])
                        imax[k] = np.where(mine & (q < pc),
                                           np.maximum(imax[k], col), imax[k])
            off = 1
            while off < s:
                src = np.minimum(lane + off, 31)      # __shfl_down_sync
                o, oq, i = omin[:, src], qmin[:, src], imax[:, src]
                take = (part + off < s) & ((o < omin) |
                                           ((o == omin) & (oq > qmin)))
                omin, qmin = np.where(take, o, omin), np.where(take, oq, qmin)
                imax = np.where(part + off < s, np.maximum(imax, i), imax)
                off *= 2
            lead = act & (part == 0)
            for k, (i_dx, i_dy, i_e, i_c) in enumerate(((0, 1, 2, 6),
                                                        (3, 4, 5, 7))):
                edge = (omin[k] >= imax[k]) & (omin[k] < big)
                qe = np.where(edge, qmin[k], pc)
                at = rows[pc[lead]]
                outs[i_dx][c, at] = np.where(edge, cx[k, qe] - cx[k, pc],
                                             0)[lead]
                outs[i_dy][c, at] = np.where(edge, cy[qe] - cy[pc], 0)[lead]
                outs[i_e][c, at] = edge[lead]
                outs[i_c][c, at] = (omin[k] > imax[k])[lead]
    return outs


def _hull_tables(rng, d, r, holes):
    """_random_tables, and with ``holes`` valid rows that are no prefix
    (the invalid rows filled as the row tables fill them)."""
    row_min, row_max, valid, abs_y = _random_tables(rng, d, r)
    if holes:
        valid = valid & (rng.random(valid.shape) < 0.6)
        row_min = np.where(valid, row_min, 1 << 30).astype(np.int32)
        row_max = np.where(valid, row_max, -(1 << 30)).astype(np.int32)
    return row_min, row_max, valid, abs_y


HULL_ROWS = [1, 31, 32, 33, 48, 96]


@pytest.mark.parametrize('holes', [False, True])
@pytest.mark.parametrize('r', HULL_ROWS)
def test_hull_warp_design_bit_equal_to_plain(r, holes):
    """The one-warp-per-component design, emulated, against the plain
    version bit for bit: R below, at and above a warp's 32 lanes and the
    pipeline's 48 and 96, valid rows as a prefix and with holes, empty
    components."""
    tabs = _hull_tables(np.random.default_rng(r + 100 * holes), 24, r, holes)
    want = lb.hull_edge_vectors_plain(*(_t(a) for a in tabs))
    got = _hull_emulated(*tabs)
    assert not tabs[2].all(axis=1).all() and tabs[2].any()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=str(i))


def test_hull_warp_design_collinear_runs():
    """The collinear chains of test_hull_collinear_runs_bit_equal: the
    emulated design picks the plain version's (farthest) endpoints."""
    r = 12
    abs_y = np.tile(np.arange(r, dtype=np.int32), (3, 1)) + 7
    row_min = np.stack([
        np.full(r, 100, np.int32),
        (100 + 2 * np.arange(r)).astype(np.int32),
        np.where(np.arange(r) < 6, 100 + 3 * np.arange(r),
                 118 - np.arange(r)).astype(np.int32)])
    tabs = (row_min, row_min + 5, np.ones((3, r), bool), abs_y)
    want = lb.hull_edge_vectors_plain(*(_t(a) for a in tabs))
    for i, (g, w) in enumerate(zip(_hull_emulated(*tabs), want)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=str(i))


def _xla_sweep(pts, valid, dx, dy):
    big = jnp.float32(3.0e38)
    px = pts[..., 0][:, None, :]
    py = pts[..., 1][:, None, :]
    pu = px * dx[:, :, None] + py * dy[:, :, None]
    pv = py * dx[:, :, None] - px * dy[:, :, None]
    vm = valid[:, None, :]
    return jax.jit(lambda: (
        jnp.min(jnp.where(vm, pu, big), axis=-1),
        jnp.max(jnp.where(vm, pu, -big), axis=-1),
        jnp.min(jnp.where(vm, pv, big), axis=-1),
        jnp.max(jnp.where(vm, pv, -big), axis=-1)))()


@pytest.mark.parametrize('d,p,k', [(40, 12, 7), (64, 32, 31), (8, 2, 1)])
def test_sweep_plain_bit_equal_to_xla_and_pallas(d, p, k):
    """Integer points and integer directions (the min_area_rect inputs):
    the plain version equals the XLA sweep and the Pallas kernel in
    interpret mode bit for bit, including an all-invalid component."""
    rng = np.random.default_rng(42)
    pts = rng.integers(0, 1228, (d, p, 2)).astype(np.float32)
    valid = rng.random((d, p)) < 0.7
    valid[0] = False
    dx = rng.integers(1, 60, (d, k)).astype(np.float32)
    dy = rng.integers(0, 48, (d, k)).astype(np.float32)
    got = lb.sweep_extents_plain(_t(pts), _t(valid), _t(dx), _t(dy))
    ref = _xla_sweep(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(dx),
                     jnp.asarray(dy))
    pal = jsweep_pallas(jnp.asarray(pts), jnp.asarray(valid),
                        jnp.asarray(dx), jnp.asarray(dy), interpret=True)
    for g, r, q in zip(got, ref, pal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(q))


def test_min_area_rect_matches_jax():
    runs, rcnt = blob_wire(3)
    ref, comp_rev, jcc = _jax_stats(runs, rcnt, 64)
    jrect = jlb.min_area_rect(
        jnp.asarray(ref['points']), jnp.asarray(ref['points_valid']),
        edge_angles=jnp.asarray(ref['edge_angles']),
        edge_valid=jnp.asarray(ref['edge_valid']),
        edge_dx=jnp.asarray(ref['edge_dx']),
        edge_dy=jnp.asarray(ref['edge_dy']))
    got = lb.min_area_rect(
        _t(ref['points']), _t(ref['points_valid']),
        edge_angles=_t(ref['edge_angles']), edge_valid=_t(ref['edge_valid']),
        edge_dx=_t(ref['edge_dx']), edge_dy=_t(ref['edge_dy']))
    ok = ref['count'] > 0
    for key in ('w', 'h'):
        np.testing.assert_array_equal(got[key].numpy()[ok],
                                      np.asarray(jrect[key])[ok], err_msg=key)
    np.testing.assert_array_equal(got['angle_deg'].numpy()[ok],
                                  np.asarray(jrect['angle_deg'])[ok])
    for key in ('cx', 'cy'):
        np.testing.assert_allclose(got[key].numpy()[ok],
                                   np.asarray(jrect[key])[ok], atol=1e-4,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize('cv2_centers', [True, False])
@pytest.mark.parametrize('max_det', [64, 8])
def test_detect_device_rects_match_jax(cv2_centers, max_det):
    """detect_from_pixels without skip_rect (the device-tracker input) on
    the same run wire: validity and counts equal, W/H/angle equal, centers
    bit-equal with cv2 centers and within 1e-4 px without."""
    runs, rcnt = blob_wire(4)
    fv = np.ones(runs.shape[0], bool)
    fv[-1] = False
    kw = dict(h=H, w=W, double_threshold=True, max_det=max_det,
              max_bh=MAX_BH, cc_iters=64, use_run_cc=True,
              cv2_centers=cv2_centers)
    ref = jdetect(None, None, rcnt, None, fv, px_runs=runs, run_counts=rcnt,
                  expanded_f=4096, use_pallas=False, **kw)
    got = detect_from_pixels(None, None, None, None, _t(fv), px_runs=_t(runs),
                             run_counts=_t(rcnt), expanded_f=4096, **kw)
    for key in ('det_valid', 'n_components'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got['det_info'].numpy(),
                                  np.asarray(ref['det_info']))
    if cv2_centers:
        np.testing.assert_array_equal(got['det_xy'].numpy(),
                                      np.asarray(ref['det_xy']))
    else:
        np.testing.assert_allclose(got['det_xy'].numpy(),
                                   np.asarray(ref['det_xy']), atol=1e-4,
                                   rtol=0)
    assert got['det_valid'].numpy()[:-1].sum() > 10


@pytest.mark.cuda
def test_hull_and_sweep_kernels_match_plain_on_cuda():
    """The hull and sweep kernels against their plain versions on the
    card, bit for bit, one launch counted per call: the hull (from min_y,
    with count) at R below, at and above a warp, valid rows with holes, an
    all-empty table and D no multiple of a block's eight warps; the sweep
    on the same tables, their corners and finished edge candidates. Runs
    on a machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    dev = torch.device('cuda')
    rng = np.random.default_rng(5)
    cases = [(d, r, holes) for d, r in ((300, 48), (7, 8), (1000, 16),
                                        (1001, 64)) for holes in (0, 1)]
    cases += [(301, r, 1) for r in HULL_ROWS] + [(64, 48, 'empty')]
    for d, r, holes in cases:
        tabs = [_t(a) for a in _hull_tables(rng, d, r, holes == 1)]
        tabs[3] = tabs[3][:, 0].contiguous()
        if holes == 'empty':
            tabs[2][:] = False
        plain = hull_edge_vectors(*tabs)
        before = hull_edge_vectors.launches
        got = hull_edge_vectors(*(a.to(dev) for a in tabs))
        torch.cuda.synchronize()
        assert hull_edge_vectors.launches == before + 1
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g.cpu().numpy(), p.numpy())
        edges = lb.edge_finish_plain(*plain[:6])
        args = tabs + list(plain[6:8]) + list(edges[:2])
        want = sweep_extents(*args)
        before = sweep_extents.launches
        got = sweep_extents(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        assert sweep_extents.launches == before + 1
        for g, q in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), q.numpy())
    # tall components: shared memory above 48 KB a block (R > 3072), and
    # the rows in global memory above the shared cap; the plain version
    # on the card (its R x R slope matrices)
    tall = np.random.default_rng(8)
    for d, r in ((5, 4000), (2, HULL_MAX_SHARED_ROWS + 1)):
        tabs = [_t(a).to(dev) for a in _hull_tables(tall, d, r, True)]
        tabs[3] = tabs[3][:, 0].contiguous()
        plain = lb.hull_tables_plain(*tabs)
        before = hull_edge_vectors.launches
        got = hull_edge_vectors(*tabs)
        torch.cuda.synchronize()
        assert hull_edge_vectors.launches == before + 1
        assert bool(plain[2].any()) and bool(plain[5].any())
        for g, p in zip(got, plain):
            assert torch.equal(g, p)


def _pixel_tables(seed, t=3, f=3072, max_det=24):
    """(T, F) pixel tables of blob frames in shuffled order: coordinates,
    dense ids (scipy's 8-connected components, ids past max_det as
    overflow), activity (some pixels dropped, padding inactive) and gray
    values."""
    from scipy import ndimage
    rng = np.random.default_rng(seed)
    xs = np.zeros((t, f), np.int32)
    ys = np.zeros((t, f), np.int32)
    seg = np.full((t, f), max_det, np.int32)
    active = np.zeros((t, f), bool)
    for k in range(t):
        img = np.zeros((H, W), np.uint8)
        for _ in range(20):
            c = (int(rng.integers(6, W - 6)), int(rng.integers(6, H - 6)))
            ax = (int(rng.integers(1, 9)), int(rng.integers(1, 4)))
            cv2.ellipse(img, c, ax, float(rng.uniform(0, 180)), 0, 360, 1, -1)
        img[10:40, 60:63] = 1                       # taller than MAX_BH
        lab, n = ndimage.label(img, structure=np.ones((3, 3)))
        yy, xx = np.nonzero(lab)
        order = rng.permutation(len(yy))[:f]
        m = len(order)
        xs[k, :m], ys[k, :m] = xx[order], yy[order]
        seg[k, :m] = np.minimum(n - lab[yy, xx][order], max_det)
        active[k, :m] = rng.random(m) < 0.97
        xs[k, m:] = rng.integers(0, W, f - m)          # garbage padding
        ys[k, m:] = rng.integers(0, H, f - m)
    gray = rng.integers(0, 256, (t, f)).astype(np.int32)
    return xs, ys, seg, active, gray


@pytest.mark.parametrize('with_gray', [True, False])
@pytest.mark.parametrize('max_det', [24, 6])
def test_component_stats_matches_jax(with_gray, max_det):
    """The segment-reduction branch of component_stats on unordered pixel
    tables, bit for bit, including the exact count and gray sum with
    luminosity and components taller than max_bh or beyond max_det. Empty
    slots and rows are compared by their validity only: their "no value"
    entries are 2^31 - 1 in JAX (an empty segment_min or segment_max) and
    +-2^30 here, and nothing reads them."""
    xs, ys, seg, active, gray = _pixel_tables(4, max_det=max_det)
    got = _with_points(lb.component_stats(
        _t(xs), _t(ys), _t(seg), _t(active),
        gray_vals=_t(gray) if with_gray else None, max_det=max_det,
        max_bh=MAX_BH))
    jfn = jax.jit(jlb.component_stats,
                  static_argnames=('max_det', 'max_bh', 'cv2_centers'))
    per = [jfn(xs[i], ys[i], seg[i], active[i],
               gray[i] if with_gray else None, max_det=max_det,
               max_bh=MAX_BH, cv2_centers=True) for i in range(len(xs))]
    ref = {k: np.concatenate([np.asarray(p[k]) for p in per])
           for k in per[0]}
    keys = ['count', 'min_y', 'points_valid', 'edge_dx', 'edge_dy',
            'edge_valid', 'edge_angles', 'row_valid', 'corner_l', 'corner_r']
    assert ('lum_sum' in got) == with_gray
    valid = ref['count'] > 0
    np.testing.assert_array_equal(got['count'].numpy() > 0, valid)
    for key in keys + (['lum_sum'] if with_gray else []):
        np.testing.assert_array_equal(got[key].numpy()[valid],
                                      ref[key][valid], err_msg=key)
    for key, vkey in (('points', 'points_valid'), ('row_min_x', 'row_valid'),
                      ('row_max_x', 'row_valid')):
        v = ref[vkey]
        np.testing.assert_array_equal(got[key].numpy()[v], ref[key][v],
                                      err_msg=key)
    assert valid.sum() > (8 if max_det == 24 else 5)
