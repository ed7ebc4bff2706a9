"""Device preprocessing of the PyTorch port (ysmr_tpu_torch/ops/preprocess.py)
against the jitted JAX functions and OpenCV, on the shapes of
tests/test_preprocess.py.

Every output is compared bit for bit. The float32 adaptive mean is held to
the jitted JAX function (XLA:CPU contracts its taps into fmas; the port
forms the same fmas exactly) and, through the threshold, to
cv2.adaptiveThreshold, including a 922x1228 frame.
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


@pytest.mark.parametrize('shape', [(3, 61, 83), (2, 922, 1228)])
def test_adaptive_mean_matches_jitted_jax(rng, shape):
    img = rng.integers(0, 256, shape).astype(np.int32)
    ours = _np(pp.adaptive_gaussian_mean(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.adaptive_gaussian_mean)(img)))


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
