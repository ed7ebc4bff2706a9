"""Device preprocessing of the PyTorch port (ysmr_tpu_torch/ops/preprocess.py)
against the jitted JAX functions and OpenCV, on the shapes of
tests/test_preprocess.py.

Every output is compared bit for bit. The float32 adaptive mean is held to
the jitted JAX function (XLA:CPU contracts its taps into fmas; the port
forms the same fmas exactly) on the shapes that make edges of the CUDA
kernel's tiles and of the plain version's chunks, and, through the
threshold, to cv2.adaptiveThreshold, including a 922x1228 frame; the
``cuda``-marked test holds the kernel to the plain version on the card.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import preprocess as jpp
from ysmr_tpu_torch.ops import preprocess as pp

torch.set_num_threads(1)


@pytest.fixture
def frames(rng):
    return rng.integers(0, 256, (3, 61, 83, 3), dtype=np.uint8)


def _np(t):
    return t.numpy()


def test_bgr_to_gray_matches_jax_and_cv2(frames):
    ours = _np(pp.bgr_to_gray(torch.from_numpy(frames)))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.bgr_to_gray)(frames)))
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(ours[i].astype(np.uint8),
                                      cv2.cvtColor(f, cv2.COLOR_BGR2GRAY))


def test_blur3_matches_jax_and_cv2(frames):
    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    ours = _np(pp.blur3(torch.from_numpy(gray.astype(np.int32))))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.blur3)(gray.astype(np.int32))))
    for i in range(len(frames)):
        np.testing.assert_array_equal(ours[i].astype(np.uint8),
                                      cv2.GaussianBlur(gray[i], (3, 3), 0))


def test_gaussian_kernel_matches_jax():
    np.testing.assert_array_equal(pp._K11_F32, jpp._K11_F32)


#: the adaptive mean's edge shapes: one pixel, H and W under the 11 taps,
#: a partial 16-frame chunk of the plain version with W past the kernel's
#: 64-column tile, and partial 32 x 64 tiles at full size
EDGE_MEAN_SHAPES = [(1, 1, 1), (3, 7, 5), (17, 33, 129), (2, 921, 1227)]
#: values outside 0-255, as the kernel and the plain version take them
WIDE = (-70000, 70001)


@pytest.mark.parametrize('shape', [(3, 61, 83), (2, 922, 1228)] +
                         EDGE_MEAN_SHAPES)
def test_adaptive_mean_matches_jitted_jax(rng, shape):
    img = rng.integers(0, 256, shape).astype(np.int32)
    ours = _np(pp.adaptive_gaussian_mean(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.adaptive_gaussian_mean)(img)))


@pytest.mark.parametrize('shape', [(3, 61, 83), (17, 33, 129)])
def test_adaptive_mean_wide_values_match_jitted_jax(rng, shape):
    """Values in +-70,000: float32 sums far from the 0-255 range, still
    exact integers on input."""
    img = rng.integers(*WIDE, shape).astype(np.int32)
    ours = _np(pp.adaptive_gaussian_mean(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.adaptive_gaussian_mean)(img)))


def _tiled_mean(img, tile_h=32, tile_w=64):
    """csrc/adaptive_mean.cu's design, tile by tile: the clamped
    (tile_h + 10) x (tile_w + 10) window, the horizontal chain over every
    window row (halo rows from their clamped source rows), the vertical
    chain over the row sums, the ragged edge cut off."""
    t, h, w = img.shape
    k = [torch.tensor(v, dtype=torch.float32) for v in pp._K11_F32]
    out = torch.empty_like(img)
    for y0 in range(0, h, tile_h):
        for x0 in range(0, w, tile_w):
            ys = torch.arange(y0 - 5, y0 + tile_h + 5).clamp(0, h - 1)
            xs = torch.arange(x0 - 5, x0 + tile_w + 5).clamp(0, w - 1)
            win = img[:, ys][:, :, xs].to(torch.float32)
            acc = pp._taps11(pp._taps11(win, -1, k), -2, k)
            cut = torch.floor(acc + 0.5).to(torch.int32)
            out[:, y0:y0 + tile_h, x0:x0 + tile_w] = \
                cut[:, :min(tile_h, h - y0), :min(tile_w, w - x0)]
    return out


@pytest.mark.parametrize('shape', [(1, 1, 1), (3, 7, 5), (2, 70, 150)])
def test_adaptive_mean_tiled_design_matches_plain(rng, shape):
    """The kernel's tiles and clamped halo give the plain version's bits
    (in- and wide-range values)."""
    for span in ((0, 256), WIDE):
        img = torch.from_numpy(rng.integers(*span, shape).astype(np.int32))
        assert torch.equal(_tiled_mean(img),
                           pp.adaptive_gaussian_mean_plain(img))


def test_adaptive_mean_wrapper_on_cpu(rng):
    """A CPU tensor goes to the plain version and launches nothing; what the
    kernel does not take raises ValueError on any device."""
    img = torch.from_numpy(rng.integers(0, 256, (3, 40, 70)).astype(np.int32))
    pp.adaptive_gaussian_mean.launches = 0
    assert torch.equal(pp.adaptive_gaussian_mean(img),
                       pp.adaptive_gaussian_mean_plain(img))
    assert pp.adaptive_gaussian_mean.launches == 0
    for bad in (img.to(torch.int64), img.transpose(1, 2), img[0]):
        with pytest.raises(ValueError):
            pp.adaptive_gaussian_mean(bad)
    assert pp.adaptive_gaussian_mean.launches == 0


@pytest.mark.cuda
def test_adaptive_mean_kernel_matches_plain_on_cuda(rng):
    """The kernel of csrc/adaptive_mean.cu against the plain version on the
    card, bit for bit, on the edge shapes, on values in +-70,000 and on a
    seeded 64 x 922 x 1228 batch; one launch counted per call. Runs on a
    machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    cases = [(s, (0, 256)) for s in EDGE_MEAN_SHAPES + [(64, 922, 1228)]]
    cases += [(s, WIDE) for s in EDGE_MEAN_SHAPES]
    for shape, span in cases:
        img = torch.from_numpy(
            rng.integers(*span, shape).astype(np.int32)).to(dev)
        pp.adaptive_gaussian_mean.launches = 0
        got = pp.adaptive_gaussian_mean(img)
        assert pp.adaptive_gaussian_mean.launches == 1
        want = pp.adaptive_gaussian_mean_plain(img)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == img.shape
        assert torch.equal(got, want), (shape, span)


@pytest.mark.parametrize('c_offset', [-7.0, -5.0, -2.5, 0.0, 3.0, 5.0, 7.5])
@pytest.mark.parametrize('white', [True, False])
def test_adaptive_threshold_matches_jax_and_cv2(rng, c_offset, white):
    img = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    ttype = cv2.THRESH_BINARY if white else cv2.THRESH_BINARY_INV
    ref = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                ttype, 11, c_offset) > 0
    ours = _np(pp.adaptive_threshold(
        torch.from_numpy(img.astype(np.int32))[None], c_offset, white))[0]
    np.testing.assert_array_equal(ours, ref)
    jfn = jax.jit(jpp.adaptive_threshold, static_argnums=(1, 2))
    np.testing.assert_array_equal(
        ours, np.asarray(jfn(img.astype(np.int32), c_offset, white)))


def test_adaptive_threshold_fullsize_matches_jax_and_cv2(rng):
    img = rng.integers(0, 256, (922, 1228), dtype=np.uint8)
    ref = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                cv2.THRESH_BINARY, 11, -5.0) > 0
    ours = _np(pp.adaptive_threshold(
        torch.from_numpy(img.astype(np.int32))[None], -5.0, True))[0]
    np.testing.assert_array_equal(ours, ref)
    jfn = jax.jit(jpp.adaptive_threshold, static_argnums=(1, 2))
    np.testing.assert_array_equal(
        ours, np.asarray(jfn(img.astype(np.int32), -5.0, True)))


def test_global_threshold_matches_jax_and_cv2(rng):
    img = rng.integers(0, 256, (4, 61, 83), dtype=np.uint8)
    thr = np.array([-3, 0, 100, 254], np.int32)
    for white, ttype in ((True, cv2.THRESH_BINARY),
                         (False, cv2.THRESH_BINARY_INV)):
        ours = _np(pp.global_threshold(torch.from_numpy(img.astype(np.int32)),
                                       torch.from_numpy(thr), white))
        np.testing.assert_array_equal(ours, np.asarray(
            jpp.global_threshold(img.astype(np.int32), thr, white)))
        for i, t in enumerate(thr):
            np.testing.assert_array_equal(
                ours[i], cv2.threshold(img[i], int(t), 255, ttype)[1] > 0)


def test_mean_std_sums_match_jax_and_cv2(rng):
    img = rng.integers(0, 256, (2, 97, 113), dtype=np.uint8)
    ours = pp.frame_mean_std_sums(torch.from_numpy(img.astype(np.int32)))
    ref = jax.jit(jpp.frame_mean_std_sums)(img.astype(np.int32))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    mean, std = pp.combine_mean_std(97 * 113, *(_np(a) for a in ours))
    for i in range(2):
        m_ref, s_ref = cv2.meanStdDev(img[i])
        assert mean[i] == pytest.approx(m_ref.item(), abs=1e-9)
        assert std[i] == pytest.approx(s_ref.item(), abs=1e-9)


@pytest.mark.parametrize('mode,white', [('adaptive_double', True),
                                        ('adaptive', False),
                                        ('mean', True)])
def test_detect_masks_match_jitted_jax(rng, mode, white):
    """Mask and markers of every mode, bit for bit against JAX's
    detect_masks jitted as in detect_from_blurred."""
    img = rng.integers(0, 256, (3, 61, 83)).astype(np.int32)
    thr = np.array([90, 128, 200], np.int32)
    ours = pp.detect_masks(torch.from_numpy(img), mode, 5, 2.0, white,
                           global_thresholds=torch.from_numpy(thr))
    ref = jax.jit(jpp.detect_masks, static_argnums=(1, 2, 3, 4))(
        img, mode, 5, 2.0, white, global_thresholds=thr)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
