"""Mean-threshold mode's kernels on the card: ``ysmr_mean_prepare`` and
``ysmr_mean_masks`` of ``csrc/adaptive_mean.cu``
(``ysmr_tpu_torch/ops/preprocess.py::mean_prepare_from_bgr`` and
``mean_masks`` on a CUDA tensor) against their plain versions on the same
card tensors, and against the numpy models of their designs in the root
module ``mean_mode_cases.py`` that ``tests/test_torch_mean_mode.py``
holds to the plain versions and ysmr_tpu on the CPU; mean mode's
``detect_batch`` on ``cuda`` against ``cpu``. This file imports no JAX.

Tolerance: none. The blurred frames, the gray frames and the sums are
integers (the sums wrap modulo 2^32 in any order), the masks bools.
"""

import numpy as np
import pytest
import torch

import mean_mode_cases as mmc
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.pipeline import detect as det

#: the full-size batches besides the cases' shapes: the bench batch and
#: the 640 x 480 device step of the multi-video path
FULL_SHAPES = ((64, 922, 1228), (16, 480, 640))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _batches(rng):
    out = [mmc.bgr_frames(rng, s) for s in
           mmc.SHAPES + mmc.EDGE_SHAPES + FULL_SHAPES]
    out.append(mmc.wrap_frames())
    out.append(np.full((2, 70, 300, 3), 255, np.uint8))
    return out


@pytest.mark.cuda
def test_mean_prepare_kernel_matches_plain_on_cuda(rng):
    """The prepare kernel against its plain version, bit for bit, with and
    without the gray, one launch a call, the input untouched; its sums also
    against the design's on the small batches and the 1 x 40,000 frame of
    255s (the row sum wraps)."""
    dev = _cuda()
    for bgr_np in _batches(rng):
        bgr = torch.from_numpy(bgr_np).to(dev)
        before = bgr.clone()
        for want_gray in (False, True):
            n = pp.mean_prepare_from_bgr.launches
            got = pp.mean_prepare_from_bgr(bgr, want_gray)
            want = pp.mean_prepare_from_bgr_plain(bgr, want_gray)
            torch.cuda.synchronize()
            assert pp.mean_prepare_from_bgr.launches == n + 1
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    assert g.dtype == w.dtype and torch.equal(g, w), \
                        bgr_np.shape
        assert torch.equal(bgr, before)
        if bgr_np[..., 0].size <= 1 << 20:
            gray = got[2].cpu().numpy()
            np.testing.assert_array_equal(
                got[1].cpu().numpy(), mmc.prepare_sums_design(gray, rng))


@pytest.mark.cuda
def test_mean_prepare_kernel_off_alignment_on_cuda(rng):
    """Frames that start off a 4-byte boundary (a view into a larger
    buffer) take the byte-wise loads and stores: the same bits."""
    dev = _cuda()
    n, h, w = 3, 70, 260
    buf = torch.from_numpy(
        rng.integers(0, 256, n * h * w * 3 + 1, dtype=np.uint8)).to(dev)
    bgr = buf[1:].view(n, h, w, 3)
    got = pp.mean_prepare_from_bgr(bgr, True)
    want = pp.mean_prepare_from_bgr_plain(bgr, True)
    for g, v in zip(got, want):
        assert torch.equal(g, v)


@pytest.mark.cuda
def test_mean_masks_kernel_matches_plain_on_cuda(rng):
    """The masks kernel against its plain version and its design, bit for
    bit, white and dark, thresholds of 0, 255 and beyond, padding frames
    at the end and between valid ones, one launch a call; the 16-byte
    path with frames starting off 16-byte boundaries (the bench batch: 8
    mod 16; the cases' planes 8 and 1 mod 16; a view 16 bytes in) and the
    byte path (a view off the mask's alignment)."""
    dev = _cuda()
    shapes = mmc.SHAPES + mmc.EDGE_SHAPES + FULL_SHAPES
    for shape in shapes:
        blurred_np = rng.integers(0, 256, shape).astype(np.uint8)
        views = []
        for off in (1, 16):
            buf = torch.empty(blurred_np.size + off, dtype=torch.uint8,
                              device=dev)
            views.append(buf[off:].view(shape).copy_(
                torch.from_numpy(blurred_np)))
        for blurred in [torch.from_numpy(blurred_np).to(dev)] + views:
            thr = torch.from_numpy(mmc.frame_thresholds(rng, shape[0]))
            for valid in (mmc.padded_valid(shape[0]),
                          mmc.gapped_valid(shape[0])):
                thr, valid = thr.to(dev), torch.from_numpy(valid).to(dev)
                for white in (True, False):
                    n = pp.mean_masks.launches
                    got = pp.mean_masks(blurred, thr, valid, white)
                    want = pp.mean_masks_plain(blurred, thr, valid, white)
                    torch.cuda.synchronize()
                    assert pp.mean_masks.launches == n + 1
                    assert got.dtype == torch.bool and \
                        torch.equal(got, want), (shape, white)
                    if blurred_np.size <= 1 << 16:
                        vec = (blurred.data_ptr() - got.data_ptr()) % 16 == 0
                        np.testing.assert_array_equal(
                            got.cpu().numpy(),
                            mmc.masks_design(blurred_np, thr.cpu().numpy(),
                                             valid.cpu().numpy(), white,
                                             blurred.data_ptr() % 16, vec))


@pytest.mark.cuda
@pytest.mark.parametrize('dark,lum', [(False, False), (True, False),
                                      (False, True)])
def test_detect_batch_mean_on_cuda_equals_cpu(rng, dark, lum):
    """Mean mode's detect_batch on the card against the CPU, two batches
    (the second short): the tables bit for bit, the moving-average windows
    equal, one prepare and one masks launch a batch."""
    dev = _cuda()
    settings = {
        'adaptive double threshold': -1.0,
        'threshold offset for detection': 10 if dark else 5,
        'white bacteria on dark background': not dark,
        'max detections per frame': 64, 'max bounding box height': 24,
        'connected components max iterations': 64,
        'include luminosity in tracking calculation': lum,
        'luminosity window size': 48}
    cfg = det.DetectorConfig(settings)
    states = [pp.MovingAverageThreshold(1, cfg.offset, cfg.white_on_dark)
              for _ in range(2)]
    for batch, count in ((0, 8), (1, 5)):
        gray = rng.normal(215 if dark else 40, 4, (8, 120, 160))
        for t in range(8):
            for y, x in rng.integers(10, 110, (12, 2)):
                gray[t, y - 3:y + 3, x - 6:x + 6] = 55 if dark else 200
        bgr = np.repeat(gray.clip(0, 255).astype(np.uint8)[..., None], 3, -1)
        valid = np.arange(8) < count
        n = (pp.mean_prepare_from_bgr.launches, pp.mean_masks.launches)
        ours = det.detect_batch(torch.from_numpy(bgr).to(dev),
                                torch.from_numpy(valid).to(dev), cfg,
                                threshold_state=states[0])
        torch.cuda.synchronize()
        assert (pp.mean_prepare_from_bgr.launches,
                pp.mean_masks.launches) == (n[0] + 1, n[1] + 1)
        ref = det.detect_batch(torch.from_numpy(bgr),
                               torch.from_numpy(valid), cfg,
                               threshold_state=states[1])
        for key in ('det_xy', 'det_info', 'det_valid', 'n_components'):
            assert torch.equal(ours[key].cpu(), ref[key]), key
    assert states[0].window == states[1].window
