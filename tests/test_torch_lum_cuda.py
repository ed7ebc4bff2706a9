"""The luminosity paths' two kernels on the card, against their plain
versions on the same card tensors, on the seeded cases of the root module
``lum_cases.py`` that ``tests/test_torch_rect_mean.py`` and
``tests/test_torch_pixel_finish.py`` hold to ysmr_tpu on the CPU. This
file imports no JAX; every test needs a CUDA device and skips elsewhere.

- ``csrc/luminosity.cu`` (``ops/luminosity.py::rect_mean_luminosity``):
  uint8 and int32 gray, windows of 16 to 64 and of 6000, clipped windows,
  zero sides, frames smaller than the window, the tiling's cases and
  wrapping corners; one launch a call, no host synchronisation; the
  refusals.
- ``csrc/pixel_finish.cu`` (``ops/cc.py::pixel_finish``) on the pixel
  kernel's labels: every combination of its outputs; one frame past the
  25,165,824 slots it once took; between the pixel kernel and what the
  host copies (the plane) or the hull reads (the tables), the luminosity
  detects launch the finish's three kernels and nothing else.

Tolerance: none. The rect mean's corners are rounded operation by
operation as the plain version's torch operations round them, and the
rest is integer arithmetic and one float32 division and product; the
finish's outputs are integers and flags.
"""

import numpy as np
import pytest
import torch

from lum_cases import (FINISH_CASES, RECT_CASES, finish_case,
                       own_root_lists, rect_case)
from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import luminosity as lum


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _rect_args(case, dev):
    gray, params, valid, win = rect_case(case)
    return ([torch.from_numpy(gray).to(dev)] +
            [torch.from_numpy(p).to(dev) for p in params] +
            [torch.from_numpy(valid).to(dev)]), win


@pytest.mark.cuda
@pytest.mark.parametrize('case', RECT_CASES)
def test_rect_mean_kernel_matches_plain_on_cuda(case):
    """The kernel against the plain version on the same card tensors, bit
    for bit, one launch, the inputs untouched."""
    dev = _cuda()
    args, win = _rect_args(case, dev)
    before = [a.clone() for a in args]
    n = lum.rect_mean_luminosity.launches
    got = lum.rect_mean_luminosity(*args, win=win)
    want = lum.rect_mean_luminosity_plain(*args, win=win)
    torch.cuda.synchronize()
    assert lum.rect_mean_luminosity.launches == n + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.cuda
def test_rect_mean_kernel_no_host_sync_on_cuda():
    """One call on the card raises no host synchronisation."""
    dev = _cuda()
    args, win = _rect_args('random', dev)
    lum.rect_mean_luminosity(*args, win=win)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = lum.rect_mean_luminosity(*args, win=win)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert out.shape == args[1].shape


@pytest.mark.cuda
def test_rect_mean_refusals_on_cuda():
    """A wrong gray type, shape or layout, a rect of another shape or
    type, a non-contiguous rect and a window below 1 raise, and no launch
    is counted."""
    dev = _cuda()
    args, win = _rect_args('win32', dev)
    n = lum.rect_mean_luminosity.launches
    bad = [
        [args[0].to(torch.int16)] + args[1:],
        [args[0][0]] + args[1:],
        [args[0].transpose(1, 2)] + args[1:],
        args[:1] + [args[1][:, :5]] + args[2:],
        args[:1] + [args[1].double()] + args[2:],
        args[:1] + [args[1].t().contiguous().t()] + args[2:],
        args[:6] + [args[6].to(torch.uint8)],
    ]
    for b in bad:
        with pytest.raises(ValueError):
            lum.rect_mean_luminosity(*b, win=win)
    with pytest.raises(ValueError, match='win'):
        lum.rect_mean_luminosity(*args, win=0)
    assert lum.rect_mean_luminosity.launches == n


def _finish_inputs(name, dev):
    case = finish_case(name)
    t = {k: torch.from_numpy(case[k]).to(dev)
         for k in ('px_x', 'px_y', 'valid', 'marker')}
    lab, keep = cc.cc_labels_at_pixels(
        t['px_x'], t['px_y'], t['valid'], t['marker'], h=case['h'],
        w=case['w'], double_threshold=case['double_threshold'])
    return case, (lab, keep, t['px_x'], t['px_y'], t['valid'])


def _modes(case):
    plane = dict(f=case['plane_f'], max_det=case['max_det'])
    tables = dict(max_det=case['max_det'], max_bh=case['max_bh'])
    return (dict(ids=True, readback=plane, row_tables=tables),
            dict(readback=plane), dict(row_tables=tables), dict(ids=True),
            dict(), dict(readback=dict(f=1, max_det=1)))


@pytest.mark.cuda
@pytest.mark.parametrize('name', FINISH_CASES)
def test_pixel_finish_kernel_matches_plain_on_cuda(name):
    """The kernel against the plain version on the pixel kernel's labels,
    every output bit-equal, for each combination of outputs; one launch
    counted a call, the inputs untouched."""
    dev = _cuda()
    case, args = _finish_inputs(name, dev)
    before = [a.clone() for a in args]
    for mode in _modes(case):
        kw = dict(h=case['h'], w=case['w'], **mode)
        n = cc.pixel_finish.launches
        got = cc.pixel_finish(*args, **kw)
        want = cc.pixel_finish_plain(*args, **kw)
        torch.cuda.synchronize()
        assert cc.pixel_finish.launches == n + 1
        assert set(got) == set(want), mode
        for k in want:
            assert got[k].dtype == want[k].dtype, (mode, k)
            assert torch.equal(got[k], want[k]), (mode, k)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.cuda
def test_pixel_finish_refusals_on_cuda():
    """Wrong types, shapes and layouts raise before the card."""
    dev = _cuda()
    case, args = _finish_inputs('tall', dev)
    kw = dict(h=case['h'], w=case['w'])
    n = cc.pixel_finish.launches
    for i, bad in ((0, args[0].to(torch.int64)), (1, args[1].to(torch.uint8)),
                   (2, args[2][:, :-1]), (3, args[3].t().contiguous().t()),
                   (4, args[4][:1])):
        with pytest.raises(ValueError):
            cc.pixel_finish(*(bad if j == i else a
                              for j, a in enumerate(args)), **kw)
    assert cc.pixel_finish.launches == n


def _kernels_between(fn, first, last):
    """The device kernels a call of ``fn`` launches after the first whose
    name holds ``first`` and before the first later one holding ``last``
    (or its end)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    start = max(i for i, nm in enumerate(names) if first in nm)
    stop = next((i for i in range(start + 1, len(names))
                 if last is not None and last in names[i]), len(names))
    return names[start + 1:stop]


@pytest.mark.cuda
def test_pixel_finish_past_the_old_cap_on_cuda():
    """One frame's list of 25,165,825 slots, one past the 25,165,824 the
    finish took while its tile offsets lived in shared memory, with its
    labels made directly (every pixel its own root, and a few components
    of several pixels): the ids, the plane, the count and the row tables
    bit-equal to the plain version, one launch counted."""
    dev = _cuda()
    f, w = 25_165_825, 8192
    h = -(-f // w)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in own_root_lists(1, f, h, w))
    kw = dict(h=h, w=w, ids=True, readback=dict(f=f, max_det=1024),
              row_tables=dict(max_det=64, max_bh=8))
    n = cc.pixel_finish.launches
    got = cc.pixel_finish(*args, **kw)
    want = cc.pixel_finish_plain(*args, **kw)
    torch.cuda.synchronize()
    assert cc.pixel_finish.launches == n + 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert int(got['n_components'][0]) == f - 39 - 8 - 6
    # hand the lists' gigabytes back: later tests trace with the profiler
    del args, got, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_rect_mean_large_windows_on_cuda():
    """A window of 6000 x 6000 pixels (a tile of 16 slots: a tile's flat
    list stays below 2^30 pixels) bit-equal to the plain version; a window
    of 2^30 pixels inside the frame raises before the card."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    gray = torch.from_numpy(rng.integers(0, 256, (1, 6000, 6000),
                                         dtype=np.uint8)).to(dev)
    # cx, cy, w, h, angle of three rects: two of thousands of pixels a
    # side, one of ten
    rects = [torch.tensor([v], dtype=torch.float32, device=dev)
             for v in ([3000.0, 2990.0, 100.5], [2000.5, 3000.0, 80.0],
                       [5900.0, 300.0, 10.0], [4000.0, 5500.0, 4.0],
                       [10.0, -30.0, 45.0])]
    valid = torch.ones((1, 3), dtype=torch.bool, device=dev)
    got = lum.rect_mean_luminosity(gray, *rects, valid, win=6000)
    want = lum.rect_mean_luminosity_plain(gray, *rects, valid, win=6000)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got, want)
    # the big boxes' int32 sums wrap, as the plain version's do
    assert (got != 0).all(), got
    big = torch.empty((1, 1 << 15, 1 << 15), dtype=torch.uint8, device=dev)
    n = lum.rect_mean_luminosity.launches
    with pytest.raises(ValueError, match='2\\^30'):
        lum.rect_mean_luminosity(big, *rects, valid, win=1 << 15)
    assert lum.rect_mean_luminosity.launches == n
    del gray, big, got, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_luminosity_detects_launch_only_the_finish_on_cuda():
    """With luminosity in pixels mode, the host-rect detect (the plane)
    and the device-rect detect (the tables) launch the finish's three
    kernels (roots, offsets, ids) and nothing else between the pixel
    kernel's last launch and the host copy or the hull kernel."""
    from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
    dev = _cuda()
    case = finish_case('blobs')
    kw = dict(px_x=torch.from_numpy(case['px_x'].astype(np.int16)).to(dev),
              px_y=torch.from_numpy(case['px_y'].astype(np.int16)).to(dev),
              px_marker=torch.from_numpy(case['marker'].astype(np.uint8)).to(
                  dev),
              px_counts=torch.from_numpy(case['counts']).to(dev),
              frame_valid=torch.from_numpy(case['frame_valid']).to(dev),
              h=case['h'], w=case['w'], double_threshold=True,
              max_det=case['max_det'], max_bh=case['max_bh'], cc_iters=64)
    gray = torch.randint(0, 256, (len(case['counts']), case['h'], case['w']),
                         dtype=torch.uint8, device=dev)
    plane = _kernels_between(
        lambda: detect_from_pixels(**kw, readback_pixels=case['plane_f']),
        'px_final', None)
    finish = ('finish_roots', 'finish_offsets', 'finish_ids')
    assert len(plane) == 3 and all(
        k in nm for k, nm in zip(finish, plane)), plane
    tables = _kernels_between(
        lambda: detect_from_pixels(**kw, include_luminosity=True,
                                   gray_frames=gray), 'px_final', 'hull')
    assert len(tables) == 3 and all(
        k in nm for k, nm in zip(finish, tables)), tables
