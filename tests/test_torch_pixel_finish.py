"""The pixel-table branch's finish of the PyTorch port (ysmr_tpu_torch/ops/
cc.py::pixel_finish): its plain version against ysmr_tpu on the CPU (the
dense ids and count of ``detect_from_pixels``' ``compact_ids`` through its
``det_px_idx`` and ``n_components``, and the row tables of
``ysmr_tpu/ops/labeling.py::component_stats``), for the host-rect plane
and the device rects' tables, on the cases of the root module
``lum_cases.py`` and on the split wires of the three synthetic clips; a
numpy emulation of the CUDA kernel's design (``csrc/pixel_finish.cu``)
against the plain version; the wrapper's routes and refusals. The kernel
itself is held to the plain version on the card by
``tests/test_torch_lum_cuda.py``.

Tolerance: none; every output is an integer id, count, extreme or flag.
The tables' empty entries are compared by their flags only: ysmr_tpu's
empty segment_min and segment_max give 2^31 - 1, the port +-2^30, and
nothing reads them.
"""

import jax
import numpy as np
import pytest
import torch

from lum_cases import FINISH_CASES, finish_case
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels as jdetect
from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import labeling as lb

torch.set_num_threads(1)

#: enough propagation steps for every component of the cases: the finish's
#: contract is the converged labels (the kernel always converges)
ITERS = 400


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _labels(case):
    """The plain labels of a case's lists: (lab_fg, keep) tensors and the
    finish's other inputs."""
    lab, keep, steps = cc.cc_labels_at_pixels_plain(
        _t(case['px_x']), _t(case['px_y']), _t(case['valid']),
        _t(case['marker']), h=case['h'], w=case['w'],
        double_threshold=case['double_threshold'], max_iters=ITERS)
    assert (steps < ITERS).all()
    return lab, keep, _t(case['px_x']), _t(case['px_y']), _t(case['valid'])


def _finish_kw(case, ids=True):
    return dict(h=case['h'], w=case['w'], ids=ids,
                readback=dict(f=case['plane_f'], max_det=case['max_det']),
                row_tables=dict(max_det=case['max_det'],
                                max_bh=case['max_bh']))


def _jax_tables(px_x, px_y, det_px, max_det, max_bh):
    """ysmr_tpu's component_stats row tables, frame by frame, of the
    pixels whose detection index is below max_det."""
    jfn = jax.jit(jlb.component_stats,
                  static_argnames=('max_det', 'max_bh', 'cv2_centers'))
    per = []
    for i in range(len(px_x)):
        seg = np.where(det_px[i] >= 0, det_px[i], max_det).astype(np.int32)
        # cv2_centers: the output carries the row tables
        per.append(jfn(px_x[i], px_y[i], seg, det_px[i] >= 0,
                       max_det=max_det, max_bh=max_bh, cv2_centers=True))
    return {k: np.concatenate([np.asarray(p[k]) for p in per])
            for k in ('row_min_x', 'row_max_x', 'row_valid', 'min_y',
                      'count')}


def _check_against_jax(case, got, keep):
    """The plain finish's outputs against ysmr_tpu's detect on the same
    wire (its CPU path) and its component_stats."""
    ref = jdetect(case['px_x'], case['px_y'], case['counts'],
                  case['marker'].astype(np.uint8), case['frame_valid'],
                  h=case['h'], w=case['w'],
                  double_threshold=case['double_threshold'],
                  max_det=case['max_det'], max_bh=case['max_bh'],
                  cc_iters=ITERS, return_det_px=True, skip_rect=True,
                  use_pallas=False)
    det = np.asarray(ref['det_px_idx'])
    n = np.asarray(ref['n_components'])
    f = case['plane_f']
    np.testing.assert_array_equal(got['n_components'].numpy(), n)
    plane = got['readback'].numpy()
    assert plane.dtype == np.int16 and plane.shape == (len(n), f + 2)
    np.testing.assert_array_equal(plane[:, :f], det[:, :f])
    np.testing.assert_array_equal(plane[:, f], np.minimum(n, 32767))
    assert (plane[:, f + 1] == 0).all()
    comp = got['comp'].numpy()
    md = case['max_det']
    np.testing.assert_array_equal(np.where(comp < md, comp, -1)[
        case['valid']], det[case['valid']])
    assert (comp[~keep.numpy()] == comp.shape[1]).all()
    jt = _jax_tables(case['px_x'], case['px_y'], det, md, case['max_bh'])
    rv = jt['row_valid']
    np.testing.assert_array_equal(got['row_valid'].numpy(), rv)
    occupied = jt['count'] > 0
    np.testing.assert_array_equal(got['min_y'].numpy()[occupied],
                                  jt['min_y'][occupied])
    assert (got['min_y'].numpy()[~occupied] == lb.BIG_I).all()
    for k in ('row_min_x', 'row_max_x'):
        np.testing.assert_array_equal(got[k].numpy()[rv], jt[k][rv],
                                      err_msg=k)
    assert (got['row_min_x'].numpy()[~rv] == lb.BIG_I).all()
    assert (got['row_max_x'].numpy()[~rv] == -lb.BIG_I).all()
    return n


@pytest.mark.parametrize('name', FINISH_CASES)
def test_plain_finish_matches_jax_on_cases(name):
    """Blobs over several tiles, frames with 0, 1 and max_det + 1
    components, components taller than max_bh, an invalid frame, a full
    list, a band across two tiles, the single threshold: the plane, the
    ids, the count and the row tables equal ysmr_tpu's."""
    case = finish_case(name)
    args = _labels(case)
    got = cc.pixel_finish_plain(*args, **_finish_kw(case))
    n = _check_against_jax(case, got, args[1])
    if name == 'counts_0_1_overflow':
        assert list(n[:3]) == [0, 1, case['max_det'] + 1]


@pytest.mark.parametrize('clip', ['adaptive_double',
                                  'mean_threshold_no_gsff', 'dark_bacteria'])
def test_plain_finish_matches_jax_on_clip_wires(tmp_path, clip):
    """The split pixel wire of luminosity, as the host threshold writes it
    for the first 8 frames of each synthetic clip of the end-to-end tests,
    through both."""
    import cv2
    from test_e2e_parity import _make_settings, make_synthetic_video
    from test_torch_track_bacteria import CLIPS
    from ysmr_tpu_torch.io.preproc import HostPreprocessor
    video_kw, extra = CLIPS[clip]
    path = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=8,
                                **video_kw)
    settings = {**_make_settings(tmp_path), **extra,
                'include luminosity in tracking calculation': True}
    pre = HostPreprocessor(settings, 30.0, max_fg=4096)
    cap = cv2.VideoCapture(path)
    tabs = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        tabs.append(pre(frame))
    cap.release()
    counts = np.array([tb['count'] for tb in tabs], np.int32)
    f = 4096
    valid = np.arange(f)[None, :] < counts[:, None]
    wire = {k: np.where(valid, np.stack([tb[k] for tb in tabs]), 0)
            for k in ('px_x', 'px_y', 'px_marker')}
    case = dict(
        px_x=wire['px_x'].astype(np.int32), px_y=wire['px_y'].astype(np.int32),
        marker=wire['px_marker'] > 0, counts=counts,
        frame_valid=np.ones(len(tabs), bool), valid=valid,
        h=288, w=384, double_threshold=pre.mode == 'adaptive_double',
        max_det=64, max_bh=24, plane_f=1024)
    args = _labels(case)
    got = cc.pixel_finish_plain(*args, **_finish_kw(case))
    n = _check_against_jax(case, got, args[1])
    assert n.sum() > 8 * 5


# ---- the kernel's design in numpy ----

def finish_emulation(lab, keep, px_x, px_y, valid, *, h, w, ids, readback,
                     row_tables, tile=2048, threads=256):
    """``csrc/pixel_finish.cu``'s design: a roots launch over tiles (the
    root flags ranked in slot order, each root's lin at its in-tile rank in
    the tile's list, the tile's count and first lin; the tables filled),
    an offsets launch (each frame's tile counts to exclusive offsets in
    place, the count) and an ids launch of a thread a slot: the root's tile
    the last between those of slots i - (lin(i) - label) and i whose first
    lin is at most the label, its rank the tile's offset + the label's
    place in the tile's list (both binary searches, the list's entry
    checked to be the label); the warp's runs of equal component and y
    taking one minimum at their first lane and one maximum at their
    last."""
    lab, keep, px_x, px_y, valid = (a.numpy() for a in
                                    (lab, keep, px_x, px_y, valid))
    t, f = lab.shape
    tiles = -(-f // tile)
    lin = (px_y.astype(np.int64) * w + px_x).astype(np.int32)
    tile_roots = np.full((t, f), -12345, np.int64)   # written at ranks only
    counts = np.zeros((t, tiles), np.int64)
    firsts = np.full((t, tiles), np.iinfo(np.int32).max, np.int64)
    for fr in range(t):
        for k in range(tiles):
            t0 = k * tile
            if not valid[fr, t0]:
                continue
            sl = slice(t0, min(t0 + tile, f))
            root = valid[fr, sl] & keep[fr, sl] & (lab[fr, sl] == lin[fr, sl])
            roots = lin[fr, sl][root]
            tile_roots[fr, t0:t0 + len(roots)] = roots
            counts[fr, k] = len(roots)
            firsts[fr, k] = lin[fr, t0]
    # offsets, in place
    n_comp = counts.sum(1)
    offsets = np.cumsum(counts, 1) - counts
    out = {'n_components': n_comp.astype(np.int32)}
    comp = np.full((t, f), f, np.int64)
    for fr in range(t):
        for i in np.nonzero(keep[fr])[0]:
            label = int(lab[fr, i])
            hi = i // tile
            lo = min(max(i - int(lin[fr, i]) + label, 0) // tile, hi)
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if firsts[fr, mid] <= label:
                    lo = mid
                else:
                    hi = mid - 1
            o = offsets[fr, lo]
            a = 0
            b = (offsets[fr, lo + 1] if lo + 1 < tiles else n_comp[fr]) - o - 1
            lst = tile_roots[fr, lo * tile:]
            while a < b:
                mid = (a + b) >> 1
                if lst[mid] < label:
                    a = mid + 1
                else:
                    b = mid
            assert lst[a] == label, (fr, i, label)
            comp[fr, i] = n_comp[fr] - 1 - (o + a)
    if row_tables is not None:
        md, mbh = row_tables['max_det'], row_tables['max_bh']
        rmin = np.full((t * md, mbh), lb.BIG_I, np.int64)
        rmax = np.full((t * md, mbh), -lb.BIG_I, np.int64)
        rval = np.zeros((t * md, mbh), bool)
        min_y = np.full(t * md, lb.BIG_I, np.int64)
        for fr in range(t):
            for i in np.nonzero(keep[fr] & (lab[fr] == lin[fr]))[0]:
                if comp[fr, i] < md:
                    min_y[fr * md + comp[fr, i]] = px_y[fr, i]
            for s0 in range(0, f, 32):              # a warp's 32 lanes
                for i in range(s0, min(s0 + 32, f)):
                    c = comp[fr, i]
                    if not keep[fr, i] or c >= md:
                        continue
                    y, x = px_y[fr, i], px_x[fr, i]

                    def same(j):
                        return (s0 <= j < min(s0 + 32, f) and keep[fr, j]
                                and comp[fr, j] == c and px_y[fr, j] == y)
                    r = min(max(y - lab[fr, i] // w, 0), mbh - 1)
                    e = (fr * md + c, r)
                    if not same(i - 1):
                        rmin[e] = min(rmin[e], x)
                        rval[e] = True
                    if not same(i + 1):
                        rmax[e] = max(rmax[e], x)
    if ids:
        out['comp'] = comp.astype(np.int32)
    if readback is not None:
        fb, pmd = readback['f'], readback['max_det']
        det = np.where(keep & (comp < pmd), comp, -1)[:, :fb]
        out['readback'] = np.concatenate(
            [det, np.minimum(out['n_components'], 32767)[:, None],
             np.zeros((t, 1), np.int64)], 1).astype(np.int16)
    if row_tables is not None:
        out.update(row_min_x=rmin.astype(np.int32),
                   row_max_x=rmax.astype(np.int32), row_valid=rval,
                   min_y=min_y.astype(np.int32))
    return out


@pytest.mark.parametrize('tile', [2048, 64, 32])
@pytest.mark.parametrize('name', FINISH_CASES)
def test_finish_design_matches_plain(name, tile):
    """The kernel's design, emulated at its tile of 2048 slots and at 64
    and 32 (many tiles, roots ranked across them, offsets in global
    memory), equal to the plain version for the plane, the ids, the count
    and every table entry; every root found by its group's one search."""
    case = finish_case(name)
    args = _labels(case)
    kw = _finish_kw(case)
    want = cc.pixel_finish_plain(*args, **kw)
    got = finish_emulation(*args, tile=tile, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_wrapper_routes_and_refusals():
    """A CPU tensor goes to the plain version (no launch), each output as
    asked; another device raises; so do a plane wider than the lists and
    empty tables."""
    case = finish_case('tall')
    args = _labels(case)
    n = cc.pixel_finish.launches
    only = cc.pixel_finish(*args, h=case['h'], w=case['w'])
    assert set(only) == {'n_components'}
    full = cc.pixel_finish(*args, **_finish_kw(case))
    assert set(full) == {'n_components', 'comp', 'readback'} | \
        set(cc.TABLE_KEYS)
    assert cc.pixel_finish.launches == n
    with pytest.raises(ValueError, match='unsupported device'):
        cc.pixel_finish(*(a.to('meta') for a in args), h=case['h'],
                        w=case['w'])
    with pytest.raises(ValueError, match='readback'):
        cc.pixel_finish(*args, h=case['h'], w=case['w'],
                        readback=dict(f=args[0].shape[1] + 1, max_det=8))
    with pytest.raises(ValueError, match='row_tables'):
        cc.pixel_finish(*args, h=case['h'], w=case['w'],
                        row_tables=dict(max_det=0, max_bh=8))
