"""The luminosity paths' two kernels on the card, against their plain
versions on the same card tensors, on the seeded cases of the root module
``lum_cases.py`` that ``tests/test_torch_rect_mean.py`` and
``tests/test_torch_pixel_finish.py`` hold to ysmr_tpu on the CPU. This
file imports no JAX; every test needs a CUDA device and skips elsewhere.

- ``csrc/luminosity.cu`` (``ops/luminosity.py::rect_mean_luminosity``):
  uint8 and int32 gray, windows of 16 to 64, clipped windows, zero sides,
  frames smaller than the window; one launch a call, no host
  synchronisation; the refusals.
- ``csrc/pixel_finish.cu`` (``ops/cc.py::pixel_finish``) on the pixel
  kernel's labels: every combination of its outputs; between the pixel
  kernel and what the host copies (the plane) or the hull reads (the
  tables), the luminosity detects launch the finish's two kernels and
  nothing else.

Tolerance: none. The rect mean's corners are rounded operation by
operation as the plain version's torch operations round them, and the
rest is integer arithmetic and one float32 division and product; the
finish's outputs are integers and flags.
"""

import numpy as np
import pytest
import torch

from lum_cases import FINISH_CASES, RECT_CASES, finish_case, rect_case
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
def test_luminosity_detects_launch_only_the_finish_on_cuda():
    """With luminosity in pixels mode, the host-rect detect (the plane)
    and the device-rect detect (the tables) launch the finish's two
    kernels and nothing else between the pixel kernel's last launch and
    the host copy or the hull kernel."""
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
    assert len(plane) == 2 and 'finish_roots' in plane[0] and \
        'finish_ids' in plane[1], plane
    tables = _kernels_between(
        lambda: detect_from_pixels(**kw, include_luminosity=True,
                                   gray_frames=gray), 'px_final', 'hull')
    assert len(tables) == 2 and 'finish_roots' in tables[0] and \
        'finish_ids' in tables[1], tables
