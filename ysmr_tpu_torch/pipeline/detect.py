"""Frames-mode detection: raw BGR frames -> padded detection tables on the
device.

Counterpart of ``ysmr_tpu/pipeline/detect.py``: grayscale -> 3x3 blur ->
threshold (one of three modes) -> marker reconstruction -> 8-connected
labels -> compaction -> row tables -> hull -> exact rect, batched over T
frames. The labeling and the reconstruction are the kernels of
``csrc/cc.cu`` on a CUDA tensor (``ops/cc.py``), the compaction and row
tables one call of ``csrc/compact.cu`` (``labeling.compact_row_tables``),
their plain versions on a CPU one; the hull and sweep kernels run inside
the stats tail as on the run wire.

In the adaptive modes ``detect_batch`` (and the multi-video step and
``graft_entry``) goes from the BGR frames to the masks in one call,
``preprocess.adaptive_masks_from_bgr`` (a single kernel launch on the
card), then ``detect_from_masks``. In mean-threshold mode it takes
``preprocess.mean_prepare_from_bgr`` (the blurred frames and the
meanStdDev sums), one copy of the sums and ``frame_valid`` to the host for
the moving-average thresholds, then ``preprocess.mean_masks`` and
``detect_from_masks``: one launch each on the card. ``prepare_batch`` and
``detect_from_blurred``, the JAX functions' counterparts, keep the
separate gray, blur and threshold passes.

Differences from the JAX module:

- Plain PyTorch runs eagerly, so there is no jit; ``detect_from_blurred``
  takes the batch's components through ``ops/labeling.py`` in one pass
  over (T*max_det, ...) tables instead of ``vmap``ping a frame at a time.
- No cv2-center override, as in JAX: frames mode reports the exact rect
  center (``detect_from_blurred`` has no ``cv2_centers``).
- With luminosity the third ``det_xy`` column is the exact rect mean of
  the gray frames (``ops/luminosity.py``), at the exact rect center.
"""

import numpy as np
import torch

from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.pipeline.detect_pixels import detections_from_tables


class DetectorConfig:
    """Static detection parameters derived from tracking.ini settings."""

    def __init__(self, settings):
        self.mode, self.offset = pp.resolve_detection_rule(settings)
        self.white_on_dark = settings['white bacteria on dark background']
        self.double_delta = settings['adaptive double threshold']
        self.max_det = settings['max detections per frame']
        self.max_bh = settings.get('max bounding box height', 96)
        self.cc_iters = settings['connected components max iterations']
        self.include_luminosity = settings['include luminosity in tracking calculation']
        self.lum_win = settings.get('luminosity window size', 48)


def prepare_batch(frames_bgr, needs_sums=False):
    """BGR frames -> (gray, blurred[, meanStdDev integer sums]).

    Separate from :func:`detect_from_blurred` so mean-threshold mode can
    compute per-frame thresholds on the host (the 5 s moving-average state)
    between the two without converting again.

    :param frames_bgr: (T, H, W, 3) uint8
    """
    gray = pp.bgr_to_gray(frames_bgr)
    blurred = pp.blur3(gray)
    if needs_sums:
        return (gray, blurred) + pp.frame_mean_std_sums(gray)
    return gray, blurred


def detect_from_blurred(gray, blurred, frame_valid, thresholds, *, mode,
                        white_on_dark, offset, double_delta, max_det, max_bh,
                        cc_iters, include_luminosity=False, lum_win=48):
    """Detection tables from preprocessed frames.

    :param gray: (T, H, W) gray frames (read with ``include_luminosity``)
    :param blurred: (T, H, W) int32
    :param frame_valid: (T,) bool — padding frames yield no detections
    :param thresholds: (T,) int32 per-frame global thresholds (mean mode;
        ignored by the adaptive modes)
    :return: dict with det_xy (T, D, K) (K = 3 with luminosity), det_info
        (T, D, 3) [w, h, angle_deg], det_valid (T, D), n_components (T,)
    """
    mask, markers = pp.detect_masks(blurred, mode, offset, double_delta,
                                    white_on_dark, global_thresholds=thresholds)
    fv = frame_valid[:, None, None]
    return detect_from_masks(
        gray, mask & fv, None if markers is None else markers & fv,
        max_det=max_det, max_bh=max_bh, cc_iters=cc_iters,
        include_luminosity=include_luminosity, lum_win=lum_win)


def detect_from_masks(gray, mask, markers, *, max_det, max_bh, cc_iters,
                      include_luminosity=False, lum_win=48):
    """Detection tables from the thresholded frames: marker reconstruction,
    8-connected labels, compaction, row tables, hull and exact rect.

    :param gray: (T, H, W) gray frames (read with ``include_luminosity``)
    :param mask: (T, H, W) bool, padding frames already all False
    :param markers: (T, H, W) bool or None (single threshold)
    :return: as :func:`detect_from_blurred`
    """
    if markers is not None:
        mask = cc.binary_reconstruct(mask, markers, max_iters=cc_iters)
    # the compaction reads the mask as the labeling packed it
    labels8, bits = cc.label_components_whole_frame(
        mask, connectivity=8, max_iters=cc_iters, return_bits=True)
    *rows, n_components = lb.compact_row_tables(labels8, mask,
                                                max_det=max_det,
                                                max_bh=max_bh, fg_bits=bits)
    tables = lb._stats_tail_from_tables(*rows)
    return detections_from_tables(
        tables, mask.shape[0], max_det=max_det, max_bh=max_bh,
        n_components=n_components,
        gray_frames=gray if include_luminosity else None, lum_win=lum_win)


def detect_adaptive(frames_bgr, frame_valid, *, mode, white_on_dark, offset,
                    double_delta, max_det, max_bh, cc_iters,
                    include_luminosity=False, lum_win=48):
    """Detection tables from BGR frames in the adaptive modes: the masks
    from ``preprocess.adaptive_masks_from_bgr`` (the gray frames too with
    luminosity), then :func:`detect_from_masks`. The keywords are
    :func:`detect_from_blurred`'s.

    :param frames_bgr: (T, H, W, 3) uint8, contiguous
    :param frame_valid: (T,) bool on the device of ``frames_bgr``
    """
    mask, markers, gray = pp.adaptive_masks_from_bgr(
        frames_bgr, frame_valid, mode, offset, double_delta, white_on_dark,
        want_gray=include_luminosity)
    return detect_from_masks(gray, mask, markers, max_det=max_det,
                             max_bh=max_bh, cc_iters=cc_iters,
                             include_luminosity=include_luminosity,
                             lum_win=lum_win)


def detect_batch(frames_bgr, frame_valid, config, threshold_state=None):
    """Full host-coordinated detection for one frame batch.

    In mean-threshold mode this is the two-phase flow of
    :func:`detect_mean`: device sums -> host moving-average thresholds ->
    device detection. ``threshold_state`` is a
    :class:`ysmr_tpu_torch.ops.preprocess.MovingAverageThreshold` carried
    across batches. The adaptive modes run :func:`detect_adaptive`.

    :param frames_bgr: (T, H, W, 3) uint8 tensor
    :param frame_valid: (T,) bool tensor on the device of ``frames_bgr``
    """
    if config.mode == 'mean':
        return detect_mean(frames_bgr, frame_valid, config, threshold_state)
    return detect_adaptive(
        frames_bgr, frame_valid, mode=config.mode,
        white_on_dark=config.white_on_dark, offset=config.offset,
        double_delta=config.double_delta, max_det=config.max_det,
        max_bh=config.max_bh, cc_iters=config.cc_iters,
        include_luminosity=config.include_luminosity, lum_win=config.lum_win)


def detect_mean(frames_bgr, frame_valid, config, threshold_state):
    """Mean-threshold mode's :func:`detect_batch`: the blurred frames and
    meanStdDev sums from ``preprocess.mean_prepare_from_bgr``, one copy of
    the sums and ``frame_valid`` to the host, where ``threshold_state``
    sets each valid frame's threshold in order (uploaded from pinned
    memory: the sums' copy is the one host synchronisation), then the
    masks from ``preprocess.mean_masks`` and :func:`detect_from_masks`."""
    t = frames_bgr.shape[0]
    blurred, sums, gray = pp.mean_prepare_from_bgr(
        frames_bgr, want_gray=config.include_luminosity)
    host = torch.cat((sums, frame_valid[:, None].to(torch.int32)),
                     dim=1).cpu().numpy()
    n_pix = frames_bgr.shape[1] * frames_bgr.shape[2]
    mean, std = pp.combine_mean_std(n_pix, host[:, 0], host[:, 1],
                                    host[:, 2])
    thr = np.zeros((t,), np.int32)
    for i in range(t):
        if host[i, 3]:
            thr[i] = threshold_state.update(mean[i], std[i])
    thresholds = torch.from_numpy(thr)
    if frames_bgr.is_cuda:
        # from pinned memory the upload is queued without a host sync
        thresholds = thresholds.pin_memory().to(frames_bgr.device,
                                                non_blocking=True)
    mask = pp.mean_masks(blurred, thresholds, frame_valid,
                         config.white_on_dark)
    return detect_from_masks(gray, mask, None, max_det=config.max_det,
                             max_bh=config.max_bh, cc_iters=config.cc_iters,
                             include_luminosity=config.include_luminosity,
                             lum_win=config.lum_win)
