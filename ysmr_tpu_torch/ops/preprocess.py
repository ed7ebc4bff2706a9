# The host helpers (MovingAverageThreshold, detect_mode_from_settings,
# resolve_detection_rule, effective_threshold_offset, combine_mean_std) are
# copied from ysmr_tpu/ops/preprocess.py.
"""Frame preprocessing: grayscale, blur and the three threshold modes.

Counterpart of ``ysmr_tpu/ops/preprocess.py``: the device half of frames
mode (``bgr_to_gray``, ``blur3``, ``adaptive_gaussian_mean``,
``adaptive_threshold``, ``global_threshold``, ``frame_mean_std_sums``,
``detect_masks``) as plain PyTorch on (T, H, W) tensors of the CPU or a
GPU, but for the adaptive mean, a hand-written kernel on a GPU (below),
and the host helpers, copied unchanged. The JAX module's docstring gives the
OpenCV recipes each function reproduces.

Frames mode in the adaptive modes takes one call instead of that chain:
``adaptive_masks_from_bgr`` goes from the BGR frames to the mask and the
markers (and, for luminosity, the gray frames) in one launch of
``csrc/adaptive_mean.cu``'s second entry on a CUDA tensor, and through
``adaptive_masks_from_bgr_plain`` (``bgr_to_gray``, ``blur3``,
``adaptive_gaussian_mean_plain``, the rules and ``& frame_valid``: the
chain of ``ysmr_tpu/pipeline/detect.py``) on a CPU one, the same bits.
Mean-threshold mode, whose thresholds come from the host between the gray
frames and the masks, takes two calls: ``mean_prepare_from_bgr`` (the
blurred frames as uint8, the meanStdDev sums of ``frame_mean_std_sums``
and, for luminosity, the gray frames; ``csrc/adaptive_mean.cu``'s
``ysmr_mean_prepare``) and, after the host's thresholds,
``mean_masks`` (``global_threshold & frame_valid``; ``ysmr_mean_masks``),
each one launch on a CUDA tensor and ``*_plain`` (the same torch passes)
on a CPU one.

Bits that differ by construction and what the port does about them:

- The 11-tap float32 mean is spelt as the jitted JAX function computes it.
  XLA:CPU contracts ``sum(p[i] * k[i] for i in range(11))`` into
  ``fma(p0, k0, p1 * k1)`` followed by ``fma(p_i, k_i, acc)`` for
  i = 2..10 (measured on 1.1 M pixels: equal in every accumulator bit);
  the unfused products differ in about a third of the accumulators and in
  the rounded mean of a few pixels per million. On a CUDA tensor
  ``adaptive_gaussian_mean`` launches the hand-written kernel
  ``csrc/adaptive_mean.cu``, which forms those fmas with ``__fmaf_rn`` in
  one pass. The plain version, ``adaptive_gaussian_mean_plain``, forms them
  exactly in float64 (``ds.fma_f32``); it is what a CPU tensor runs and
  what the tests hold to the jitted JAX function. Both give the same bits.
  No convolution routine is used: its summation order (and TF32 on the
  GPU) would differ.
- The integer sums of ``frame_mean_std_sums`` widen to int64 in PyTorch;
  they are cast back to int32, the JAX types (no sum overflows).
"""

import ctypes
import math

import numpy as np
import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import ds

_I32 = torch.int32
_F32 = torch.float32

# OpenCV 8U BGR2GRAY fixed-point coefficients at shift 15 (sum == 2^15).
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798

#: frames per chunk of the adaptive mean (its float64 fma temporaries)
_MEAN_CHUNK = 16


def _gaussian_kernel_11():
    """cv2.getGaussianKernel(11, 0) — sigma = 0.3*((11-1)*0.5 - 1) + 0.8 = 2.0."""
    sigma = 0.3 * ((11 - 1) * 0.5 - 1) + 0.8
    xs = np.arange(11) - 5
    k = np.exp(-(xs.astype(np.float64) ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_K11_F32 = _gaussian_kernel_11()
#: the same taps as the kernel's argument (11 float32 values in host memory)
_K11_C = (ctypes.c_float * 11)(*(float(v) for v in _K11_F32))


def bgr_to_gray(frames_bgr):
    """Batched OpenCV-exact BGR->gray for uint8 frames.

    :param frames_bgr: (..., H, W, 3) uint8
    :return: (..., H, W) int32 grayscale in [0, 255]
    """
    if frames_bgr.is_cuda:
        bgr_to_gray.cuda_calls += 1
    acc = frames_bgr[..., 0].to(_I32) * _B2Y
    acc += frames_bgr[..., 1].to(_I32) * _G2Y
    acc += frames_bgr[..., 2].to(_I32) * _R2Y
    return (acc + (1 << 14)) >> 15


#: calls on a CUDA tensor since the count was last set to 0 (frames mode's
#: detect makes none: its preprocess is a kernel in every mode)
bgr_to_gray.cuda_calls = 0


def _pad_reflect1(x):
    """One-pixel reflect-101 border on the last two axes
    (``jnp.pad(mode='reflect')``: an axis of one pixel reflects onto
    itself)."""
    h, w = x.shape[-2:]
    a, b = min(1, w - 1), min(1, h - 1)
    x = torch.cat([x[..., :, a:a + 1], x, x[..., :, w - 1 - a:w - a]],
                  dim=-1)
    return torch.cat([x[..., b:b + 1, :], x, x[..., h - 1 - b:h - b, :]],
                     dim=-2)


def _pad_edge(x, k):
    """``k``-pixel replicate border on the last two axes
    (``jnp.pad(mode='edge')``)."""
    h, w = x.shape[-2:]
    x = torch.cat([x[..., :, :1].expand(*x.shape[:-1], k), x,
                   x[..., :, w - 1:].expand(*x.shape[:-1], k)], dim=-1)
    shp = x.shape[:-2]
    return torch.cat([x[..., :1, :].expand(*shp, k, x.shape[-1]), x,
                      x[..., h - 1:, :].expand(*shp, k, x.shape[-1])], dim=-2)


def blur3(gray):
    """OpenCV-exact 3x3 Gaussian blur (sigma 0) on integer grayscale:
    separable [64,128,64] fixed point, reflect-101 border,
    ``(acc + 2^15) >> 16``. int32 in and out, batched over leading axes."""
    if gray.is_cuda:
        blur3.cuda_calls += 1
    p = _pad_reflect1(gray.to(_I32))
    h, w = p.shape[-2:]
    tmp = p[..., :, 0:w - 2] * 64 + p[..., :, 1:w - 1] * 128 + \
        p[..., :, 2:w] * 64
    acc = tmp[..., 0:h - 2, :] * 64 + tmp[..., 1:h - 1, :] * 128 + \
        tmp[..., 2:h, :] * 64
    return (acc + (1 << 15)) >> 16


#: calls on a CUDA tensor since the count was last set to 0
blur3.cuda_calls = 0


def _taps11(p, dim, k):
    """The 11-tap float32 sum along ``dim`` in XLA:CPU's contracted order."""
    n = p.shape[dim] - 10
    acc = ds.fma_f32(p.narrow(dim, 0, n), k[0], p.narrow(dim, 1, n) * k[1])
    for i in range(2, 11):
        acc = ds.fma_f32(p.narrow(dim, i, n), k[i], acc)
    return acc


def adaptive_gaussian_mean_plain(img):
    """The 11x11 Gaussian-weighted local mean of cv2.adaptiveThreshold:
    float32 separable taps of ``getGaussianKernel(11, 0)``, replicate
    border, ``floor(acc + 0.5)``. int32 (T, H, W) in and out."""
    k = [torch.tensor(v, dtype=_F32, device=img.device) for v in _K11_F32]
    out = []
    for s in range(0, img.shape[0], _MEAN_CHUNK):
        p = _pad_edge(img[s:s + _MEAN_CHUNK].to(_F32), 5)
        acc = _taps11(_taps11(p, -1, k), -2, k)
        out.append(torch.floor(acc + 0.5).to(_I32))
    return torch.cat(out) if len(out) > 1 else out[0]


def adaptive_gaussian_mean(img):
    """The adaptive mean (contract of ``adaptive_gaussian_mean_plain``):
    a CPU tensor goes to the plain version, a CUDA tensor to the kernel of
    ``csrc/adaptive_mean.cu``; nothing falls back from one to the other.

    :param img: (T, H, W) int32, contiguous
    :return: (T, H, W) int32
    """
    if img.dim() != 3 or img.dtype != _I32 or not img.is_contiguous():
        raise ValueError('adaptive_gaussian_mean: img must be a contiguous '
                         '(T, H, W) int32 tensor')
    if img.device.type == 'cpu':
        return adaptive_gaussian_mean_plain(img)
    if img.device.type != 'cuda':
        raise ValueError('adaptive_gaussian_mean: unsupported device '
                         '{}'.format(img.device))
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.ysmr_adaptive_mean(img.data_ptr(), out.data_ptr(), _K11_C,
                                *img.shape, img.device.index, stream)
    _build.check(lib, rc, 'adaptive mean kernel launch')
    adaptive_gaussian_mean.launches += 1
    return out


#: kernel launches since the count was last set to 0
adaptive_gaussian_mean.launches = 0


def _rule_bound(c_offset, white_on_dark):
    """The integer bound of the adaptive rule with C = ``c_offset``: white
    on dark keeps ``diff > bound``, dark ``diff <= bound``."""
    if white_on_dark:
        return -int(math.ceil(c_offset))
    return -int(math.floor(c_offset))


def _adaptive_rule(img, mean, c_offset, white_on_dark):
    diff = img.to(_I32) - mean
    bound = _rule_bound(c_offset, white_on_dark)
    return diff > bound if white_on_dark else diff <= bound


def adaptive_threshold(img, c_offset, white_on_dark):
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, blockSize=11) as
    bool. ``c_offset`` is the C parameter as the reference passes it
    (already sign-adjusted for dark backgrounds); ``white_on_dark`` picks
    THRESH_BINARY over BINARY_INV.

    :param img: (T, H, W) int32 blurred grayscale
    :return: (T, H, W) bool foreground mask
    """
    return _adaptive_rule(img, adaptive_gaussian_mean(img), c_offset,
                          white_on_dark)


def global_threshold(img, thresh, white_on_dark):
    """cv2.threshold(img, T, 255, BINARY/BINARY_INV) as a bool mask.

    :param thresh: a Python int or a (T,) int32 tensor of per-frame
        thresholds (broadcast over H, W)
    """
    if img.is_cuda:
        global_threshold.cuda_calls += 1
    t = torch.as_tensor(thresh, dtype=_I32, device=img.device)
    while t.dim() < img.dim():
        t = t[..., None]
    if white_on_dark:
        return img > t
    return img <= t


#: calls on a CUDA tensor since the count was last set to 0
global_threshold.cuda_calls = 0


def frame_mean_std_sums(gray):
    """Exact integer sums for cv2.meanStdDev parity on uint8 grayscale:
    per frame (sum, sumsq_hi, sumsq_lo) as int32 with
    ``sum(x^2) = sumsq_hi * 2^16 + sumsq_lo``.

    :param gray: (T, H, W) int32 in [0, 255]
    :return: tuple of (T,) int32 tensors
    """
    if gray.is_cuda:
        frame_mean_std_sums.cuda_calls += 1
    g = gray.to(_I32)
    total = g.sum(dim=(-2, -1)).to(_I32)
    row_sums = (g * g).sum(dim=-1).to(_I32)   # <= W * 65025, fits int32
    hi = (row_sums >> 16).sum(dim=-1).to(_I32)
    lo = (row_sums & 0xFFFF).sum(dim=-1).to(_I32)
    return total, hi, lo


#: calls on a CUDA tensor since the count was last set to 0
frame_mean_std_sums.cuda_calls = 0


def combine_mean_std(n_pixels, total, hi, lo):
    """Host-side float64 mean/std from frame_mean_std_sums outputs.

    Matches cv2.meanStdDev: std = sqrt(E[x^2] - mean^2) (population std).
    """
    total = np.asarray(total, dtype=np.float64)
    sumsq = np.asarray(hi, dtype=np.float64) * 65536.0 + np.asarray(lo, dtype=np.float64)
    mean = total / n_pixels
    var = sumsq / n_pixels - mean * mean
    return mean, np.sqrt(np.maximum(var, 0.0))


def detect_masks(blurred, mode, c_offset, double_delta, white_on_dark,
                 global_thresholds=None):
    """(mask, markers) for a frame batch under the configured mode.

    ``mode`` is 'adaptive', 'adaptive_double' (adaptive plus the stricter
    marker threshold; the caller reconstructs) or 'mean' (global threshold
    per frame from ``global_thresholds``). The adaptive mean is computed
    once for both thresholds of the double mode.

    :return: (mask bool, markers bool or None)
    """
    if mode == 'mean':
        if global_thresholds is None:
            raise ValueError('mean mode requires per-frame thresholds')
        return global_threshold(blurred, global_thresholds, white_on_dark), None
    mean = adaptive_gaussian_mean(blurred)
    # the reference passes C = -offset (offset already negated for dark bg)
    mask = _adaptive_rule(blurred, mean, -c_offset, white_on_dark)
    if mode == 'adaptive_double':
        return mask, _adaptive_rule(blurred, mean, -(c_offset + double_delta),
                                    white_on_dark)
    return mask, None


def adaptive_masks_from_bgr_plain(frames_bgr, frame_valid, mode, c_offset,
                                  double_delta, white_on_dark,
                                  want_gray=False):
    """The plain version of :func:`adaptive_masks_from_bgr`: gray, blur,
    the adaptive mean, the rules of ``detect_masks`` and ``& frame_valid``
    as separate torch passes."""
    gray = bgr_to_gray(frames_bgr)
    blurred = blur3(gray)
    mean = adaptive_gaussian_mean_plain(blurred)
    fv = frame_valid[:, None, None]
    # the reference passes C = -offset (offset already negated for dark bg)
    mask = _adaptive_rule(blurred, mean, -c_offset, white_on_dark) & fv
    markers = None
    if mode == 'adaptive_double':
        markers = _adaptive_rule(blurred, mean, -(c_offset + double_delta),
                                 white_on_dark) & fv
    return mask, markers, gray if want_gray else None


#: rule bounds beyond this never change a comparison (|blur - mean| < 256);
#: the kernel takes them as C ints
_BOUND_LIMIT = 1 << 20


def _kernel_bound(c_offset, white_on_dark):
    return max(-_BOUND_LIMIT, min(_BOUND_LIMIT,
                                  _rule_bound(c_offset, white_on_dark)))


def _check_bgr(frames_bgr, what):
    if frames_bgr.dim() != 4 or frames_bgr.shape[-1] != 3 or \
            frames_bgr.dtype != torch.uint8 or \
            not frames_bgr.is_contiguous():
        raise ValueError('{}: frames_bgr must be a contiguous (N, H, W, 3) '
                         'uint8 tensor'.format(what))


def _check_frame_vector(vec, n, dtype, device, what, name):
    if tuple(vec.shape) != (n,) or vec.dtype != dtype or \
            vec.device != device or not vec.is_contiguous():
        raise ValueError('{}: {} must be a contiguous ({},) {} tensor on the '
                         'frames\' device'.format(what, name, n, dtype))


def _kernel_device(device, what):
    """True for a CUDA device, False for the CPU; raises for any other."""
    if device.type not in ('cpu', 'cuda'):
        raise ValueError('{}: unsupported device {}'.format(what, device))
    return device.type == 'cuda'


def adaptive_masks_from_bgr(frames_bgr, frame_valid, mode, c_offset,
                            double_delta, white_on_dark, want_gray=False):
    """Frames mode's preprocess in the adaptive modes in one pass: BGR
    frames to the mask and markers of ``detect_masks(blur3(bgr_to_gray(
    frames_bgr)), ...)``, each ``& frame_valid``. A CPU tensor goes to
    :func:`adaptive_masks_from_bgr_plain`, a CUDA tensor to one launch of
    ``csrc/adaptive_mean.cu``'s ``ysmr_adaptive_masks``; nothing falls back
    from one to the other.

    :param frames_bgr: (N, H, W, 3) uint8, contiguous
    :param frame_valid: (N,) bool, contiguous, on the same device
    :param mode: 'adaptive' or 'adaptive_double'
    :param c_offset, double_delta, white_on_dark: as for ``detect_masks``
    :param want_gray: also return the gray frames (luminosity)
    :return: (mask (N, H, W) bool, markers (N, H, W) bool or None,
        gray (N, H, W) int32 or None)
    """
    what = 'adaptive_masks_from_bgr'
    if mode not in ('adaptive', 'adaptive_double'):
        raise ValueError('{}: mode must be adaptive or adaptive_double, not '
                         '{!r}'.format(what, mode))
    _check_bgr(frames_bgr, what)
    n, h, w = frames_bgr.shape[:3]
    _check_frame_vector(frame_valid, n, torch.bool, frames_bgr.device, what,
                        'frame_valid')
    if not _kernel_device(frames_bgr.device, what):
        return adaptive_masks_from_bgr_plain(
            frames_bgr, frame_valid, mode, c_offset, double_delta,
            white_on_dark, want_gray)
    dev = frames_bgr.device
    mask = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    markers = torch.empty_like(mask) if mode == 'adaptive_double' else None
    gray = torch.empty((n, h, w), dtype=_I32, device=dev) if want_gray \
        else None
    if n == 0:
        return mask, markers, gray
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ysmr_adaptive_masks(
        frames_bgr.data_ptr(), frame_valid.data_ptr(), mask.data_ptr(),
        None if markers is None else markers.data_ptr(),
        None if gray is None else gray.data_ptr(), _K11_C,
        _kernel_bound(-c_offset, white_on_dark),
        _kernel_bound(-(c_offset + double_delta), white_on_dark),
        0 if white_on_dark else 1, n, h, w, dev.index, stream)
    _build.check(lib, rc, 'adaptive masks kernel launch')
    adaptive_masks_from_bgr.launches += 1
    return mask, markers, gray


#: kernel launches since the count was last set to 0
adaptive_masks_from_bgr.launches = 0


def mean_prepare_from_bgr_plain(frames_bgr, want_gray=False):
    """The plain version of :func:`mean_prepare_from_bgr`: ``bgr_to_gray``,
    ``blur3`` (as uint8: its values are 0-255) and ``frame_mean_std_sums``
    as separate torch passes."""
    gray = bgr_to_gray(frames_bgr)
    blurred = blur3(gray).to(torch.uint8)
    sums = torch.stack(frame_mean_std_sums(gray), dim=1)
    return blurred, sums, gray if want_gray else None


def mean_prepare_from_bgr(frames_bgr, want_gray=False):
    """Mean-threshold mode's preprocess in one pass: the blurred frames and
    the meanStdDev sums of every frame (``prepare_batch(needs_sums=True)``
    of the JAX package, the blur as uint8). A CPU tensor goes to
    :func:`mean_prepare_from_bgr_plain`, a CUDA tensor to
    ``csrc/adaptive_mean.cu``'s ``ysmr_mean_prepare`` (a memset of the sums
    and the kernel's row table and one launch); nothing falls back from one
    to the other.

    :param frames_bgr: (N, H, W, 3) uint8, contiguous
    :param want_gray: also return the gray frames (luminosity)
    :return: (blurred (N, H, W) uint8, sums (N, 3) int32 [total, hi, lo],
        gray (N, H, W) int32 or None)
    """
    what = 'mean_prepare_from_bgr'
    _check_bgr(frames_bgr, what)
    if not _kernel_device(frames_bgr.device, what):
        return mean_prepare_from_bgr_plain(frames_bgr, want_gray)
    n, h, w = frames_bgr.shape[:3]
    dev = frames_bgr.device
    blurred = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    # the sums, then the frames' tickets and row sums of squares
    scratch = torch.empty(n * (4 + h), dtype=_I32, device=dev)
    sums = scratch[:3 * n].view(n, 3)
    gray = torch.empty((n, h, w), dtype=_I32, device=dev) if want_gray \
        else None
    if n == 0:
        return blurred, sums, gray
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ysmr_mean_prepare(
        frames_bgr.data_ptr(), blurred.data_ptr(), scratch.data_ptr(),
        None if gray is None else gray.data_ptr(), n, h, w, dev.index,
        stream)
    _build.check(lib, rc, 'mean prepare kernel launch')
    mean_prepare_from_bgr.launches += 1
    return blurred, sums, gray


#: kernel launches since the count was last set to 0
mean_prepare_from_bgr.launches = 0


def mean_masks_plain(blurred, thresholds, frame_valid, white_on_dark):
    """The plain version of :func:`mean_masks`: ``global_threshold`` and
    ``& frame_valid``."""
    return global_threshold(blurred, thresholds, white_on_dark) & \
        frame_valid[:, None, None]


def mean_masks(blurred, thresholds, frame_valid, white_on_dark):
    """Mean-threshold mode's masks: ``blurred > t`` for white bacteria,
    ``blurred <= t`` for dark ones, t each frame's threshold, ``&
    frame_valid``. A CPU tensor goes to :func:`mean_masks_plain`, a CUDA
    tensor to one launch of ``csrc/adaptive_mean.cu``'s
    ``ysmr_mean_masks``; nothing falls back from one to the other.

    :param blurred: (N, H, W) uint8, contiguous
    :param thresholds: (N,) int32, any value, contiguous, on its device
    :param frame_valid: (N,) bool, contiguous, on its device
    :return: (N, H, W) bool
    """
    what = 'mean_masks'
    if blurred.dim() != 3 or blurred.dtype != torch.uint8 or \
            not blurred.is_contiguous():
        raise ValueError('mean_masks: blurred must be a contiguous (N, H, W) '
                         'uint8 tensor')
    n, h, w = blurred.shape
    _check_frame_vector(thresholds, n, _I32, blurred.device, what,
                        'thresholds')
    _check_frame_vector(frame_valid, n, torch.bool, blurred.device, what,
                        'frame_valid')
    if not _kernel_device(blurred.device, what):
        return mean_masks_plain(blurred, thresholds, frame_valid,
                                white_on_dark)
    dev = blurred.device
    mask = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    if mask.numel() == 0:
        return mask
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ysmr_mean_masks(
        blurred.data_ptr(), thresholds.data_ptr(), frame_valid.data_ptr(),
        mask.data_ptr(), 0 if white_on_dark else 1, n, h, w, dev.index,
        stream)
    _build.check(lib, rc, 'mean masks kernel launch')
    mean_masks.launches += 1
    return mask


#: kernel launches since the count was last set to 0
mean_masks.launches = 0


class MovingAverageThreshold:
    """The reference's 5-second moving-average global threshold state.

    Mirrors track_eval.py:221-253: per frame, threshold_i = mean + std + offset
    (white bacteria) or mean - std - offset (dark), appended to a window of at
    most ``fps * 5`` values; the applied threshold is ``int(window mean)``
    (truncation toward zero, as Python ``int()`` does).
    """

    def __init__(self, fps, offset, white_on_dark):
        self.window = []
        self.max_len = fps * 5
        self.offset = offset
        self.white_on_dark = white_on_dark

    def update(self, mean, std):
        """Feed one frame's mean/std; returns the int threshold to apply."""
        if self.white_on_dark:
            value = mean + std + self.offset
        else:
            value = mean - std - self.offset
        self.window.append(float(value))
        threshold = int(sum(self.window) / len(self.window))
        if len(self.window) > self.max_len:
            del self.window[0]
        return threshold

    def update_batch(self, means, stds):
        """Vector of thresholds for a batch of frames (sequential semantics)."""
        return np.array([self.update(m, s) for m, s in zip(means, stds)],
                        dtype=np.int32)


def detect_mode_from_settings(settings):
    """Map the 'adaptive double threshold' setting to a mode string.

    track_eval.py:185-253: > 0 double, == 0 single adaptive, < 0 mean mode.
    """
    adt = settings['adaptive double threshold']
    if adt > 0:
        return 'adaptive_double'
    if adt == 0:
        return 'adaptive'
    return 'mean'


def resolve_detection_rule(settings):
    """(mode, offset) with the reference's dark-mode double-threshold
    degeneration resolved.

    For dark bacteria the reference negates the offset in place
    (track_eval.py:125-131) and then ADDS the double-threshold delta to the
    negated value (track_eval.py:200-208), which makes the marker threshold
    WEAKER than the mask. The two rules are always nested, and scipy's
    binary_propagation keeps input pixels (dilation is extensive), so the
    reconstruction then equals the marker threshold alone — the pipeline
    must run a single adaptive threshold at the marker offset to reproduce
    the reference bit for bit (verified e2e on dark clips). Bright-mode
    semantics (marker a strict subset) are unchanged.
    """
    mode = detect_mode_from_settings(settings)
    offset = effective_threshold_offset(settings)
    if mode != 'adaptive_double':
        return mode, offset
    delta = settings['adaptive double threshold']
    c_mask = -offset
    c_marker = -(offset + delta)
    if settings['white bacteria on dark background']:
        marker_subset = -math.ceil(c_marker) >= -math.ceil(c_mask)
    else:
        marker_subset = -math.floor(c_marker) <= -math.floor(c_mask)
    if marker_subset:
        return mode, offset
    return 'adaptive', offset + delta


def effective_threshold_offset(settings):
    """Offset with the dark-background negation applied (track_eval.py:127-132).

    The reference mutates the settings dict in place; this build computes the
    effective value without mutation.
    """
    offset = settings['threshold offset for detection']
    if not settings['white bacteria on dark background']:
        offset = -offset
    return offset
