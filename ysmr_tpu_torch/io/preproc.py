# Copied from ysmr_tpu/io/preproc.py; the import lines differ, and comments
# that quoted timings of the TPU round or described the JAX package.
#!/usr/bin/env python3
"""Host-side threshold preprocessing for the bandwidth-adaptive pixels mode.

Runs inside the decode thread: grayscale -> 3x3 blur -> threshold (all via
OpenCV calls that are bit-exact with the device kernels in ops/preprocess.py
— both sides are verified against each other and against cv2 in tests) ->
single-pass foreground extraction (native C++ when built, numpy fallback).

The output per frame is a fixed-capacity pixel table: x/y int16, marker flag,
optional grayscale value (luminosity mode) — a few bytes per foreground pixel
instead of a megabyte per frame over the host-device link.
"""

import logging
import os
import threading

import cv2
import numpy as np

from ysmr_tpu_torch import native
from ysmr_tpu_torch.ops.preprocess import MovingAverageThreshold


class HostPreprocessor:
    """Per-frame host preprocessing state (threshold mode + moving average)."""

    def __init__(self, settings, fps, max_fg=16384):
        from ysmr_tpu_torch.ops.preprocess import resolve_detection_rule
        self.logger = logging.getLogger('ysmr').getChild(__name__)
        self.mode, self.offset = resolve_detection_rule(settings)
        self.white_on_dark = settings['white bacteria on dark background']
        self.double_delta = settings['adaptive double threshold']
        self.include_luminosity = settings['include luminosity in tracking calculation']
        self.color_filter = settings['color filter']
        self.max_fg = max_fg
        self.threshold_type = cv2.THRESH_BINARY if self.white_on_dark \
            else cv2.THRESH_BINARY_INV
        self.threshold_state = MovingAverageThreshold(
            fps, self.offset, self.white_on_dark) if self.mode == 'mean' else None
        self.overflowed = 0
        # fused stage 2 (adaptive modes): the native lib computes the
        # adaptive mean and thresholds it in-register, skipping the mean
        # plane. The plane path is the default (the two were not compared
        # on the H100 machine); YSMR_FUSED_STAGE2=1 opts into the fused
        # one (both are bit-identical,
        # tests/test_native.py::test_fused_stage2_bit_equals_unfused).
        self._fused_s2 = (self.mode != 'mean' and native.has_fused_stage2()
                          and os.environ.get('YSMR_FUSED_STAGE2') == '1')
        # live display (track_bacteria) needs the decoded frames alongside
        # the pixel tables; set by the pipeline when 'display video analysis'
        # is on (forces the non-fused decode path so a frame object exists)
        self.keep_frames = False
        # striped decode calls this object from several worker threads; the
        # native buffers are thread-local, only this counter is shared
        self._overflow_lock = threading.Lock()

    def _call_native(self, frame):
        """Single native pass: gray/blur/threshold/extraction in C++.

        Emits the packed uint32 wire format (lin | marker<<31) unless
        luminosity is on (that path needs the split coordinates host-side
        for the gray gather anyway).
        """
        frame = np.ascontiguousarray(frame)
        h, w = frame.shape[:2]
        if self.mode == 'mean':
            stats = native.preprocess_stage1_only(frame, need_mean=False,
                                                  want_stats=True)
            out = self._stage2_tables(h, w, mean_stats=stats)
        else:
            native.preprocess_stage1_only(frame,
                                          need_mean=not self._fused_s2)
            out = self._stage2_tables(h, w)
        if self.keep_frames:
            out['display_frames'] = frame
        return out

    def _stage2_tables(self, h, w, mean_stats=None):
        """Threshold + extraction from the thread's filled stage-1 buffers."""
        if self.mode == 'mean':
            n_px = h * w
            mean = mean_stats[0] / n_px
            std = float(np.sqrt(max(mean_stats[1] / n_px - mean * mean, 0.0)))
            thr = self.threshold_state.update(mean, std)
            s2_args = (2, self.white_on_dark, 0.0, 0.0, thr)
        else:
            mode_id = 1 if self.mode == 'adaptive_double' else 0
            if self._fused_s2:
                packed = np.zeros(self.max_fg, np.uint32)
                count = native.preprocess_stage2_fused(
                    mode_id, self.white_on_dark, -float(self.offset),
                    -float(self.offset + self.double_delta), packed)
                if count is not None:
                    if count > self.max_fg:
                        with self._overflow_lock:
                            self.overflowed += 1
                        count = self.max_fg
                    return {'px_packed': packed, 'count': count}
                # defensive fallback (unreachable with the init-time
                # capability check): refill the mean plane so the unfused
                # path below stays correct
                self._fused_s2 = False
                native.stage1_rerun_from_gray(h, w, need_mean=True)
            s2_args = (mode_id, self.white_on_dark, -float(self.offset),
                       -float(self.offset + self.double_delta), 0)
        packed = np.zeros(self.max_fg, np.uint32)
        count = native.preprocess_stage2_packed(*s2_args, packed)
        if count > self.max_fg:
            with self._overflow_lock:
                self.overflowed += 1
            count = self.max_fg
        return {'px_packed': packed, 'count': count}

    def process_jpeg(self, jpg_buf):
        """Fused native JPEG-grayscale decode + preprocessing.

        Used by the fast decode mode: libjpeg writes luma scanlines straight
        into the native gray buffer, skipping the intermediate image object.
        Returns None when the native jpeg path is unavailable or the frame
        fails to decode (caller falls back to cv2.imdecode + __call__).
        """
        if self.keep_frames or self.include_luminosity:
            # fused decode keeps no frame object (display) and no full gray
            # plane (exact rect luminosity); use the fallback path
            return None
        if self.mode == 'mean':
            res = native.decode_jpeg_gray_stage1(jpg_buf, need_mean=False,
                                                 want_stats=True)
            if res is None:
                return None
            (h, w), stats = res
            return self._stage2_tables(h, w, mean_stats=stats)
        res = native.decode_jpeg_gray_stage1(jpg_buf,
                                             need_mean=not self._fused_s2)
        if res is None:
            return None
        h, w = res
        return self._stage2_tables(h, w)

    def supports_exact_fused(self):
        """True when the libav exact-decode path can serve this run: the
        fused path keeps no frame object (display) and no full gray plane
        copy (exact rect luminosity), mirroring ``process_jpeg``'s gating."""
        return (not self.keep_frames and not self.include_luminosity
                and native.avdec_available())

    def process_jpeg_exact(self, jpg_buf):
        """Fused exact decode + preprocessing via the avdec module.

        Bit-identical to ``cv2.VideoCapture.read`` + ``__call__`` (verified
        per-file by the reader's first-frame self-check): libavcodec MJPEG ->
        libswscale BGR24 in 64-row bands -> exact gray recipe, written
        straight into the native stage-1 buffer. Returns None when the
        module is unavailable or the frame fails to decode (caller falls
        back to a full avdec/cv2 BGR decode).
        """
        if not self.supports_exact_fused():
            return None
        if self.mode == 'mean':
            res = native.avdec_gray_stage1(jpg_buf, need_mean=False,
                                           want_stats=True)
            if res is None:
                return None
            (h, w), stats = res
            return self._stage2_tables(h, w, mean_stats=stats)
        res = native.avdec_gray_stage1(jpg_buf,
                                       need_mean=not self._fused_s2)
        if res is None:
            return None
        h, w = res
        return self._stage2_tables(h, w)

    def __call__(self, frame_bgr):
        """frame -> dict of px_x, px_y, px_marker, px_gray, count."""
        default_gray = (frame_bgr.ndim == 2 or
                        self.color_filter == cv2.COLOR_BGR2GRAY)
        # luminosity mode ships the full gray plane (the exact rotated-rect
        # mean needs background pixels too); the native single-pass keeps
        # gray in its own buffers, so use the cv2 path where it is exposed
        if native.available() and default_gray and not self.include_luminosity:
            return self._call_native(frame_bgr)
        if frame_bgr.ndim == 3:
            gray = cv2.cvtColor(frame_bgr, self.color_filter)
        else:
            gray = frame_bgr
        blurred = cv2.GaussianBlur(gray, (3, 3), 0)
        markers = None
        if self.mode == 'mean':
            mean, std = cv2.meanStdDev(gray)
            thr = self.threshold_state.update(mean.item(), std.item())
            mask = cv2.threshold(blurred, thr, 255, self.threshold_type)[1]
        else:
            mask = cv2.adaptiveThreshold(
                blurred, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                self.threshold_type, 11, -float(self.offset))
            if self.mode == 'adaptive_double':
                markers = cv2.adaptiveThreshold(
                    blurred, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                    self.threshold_type, 11,
                    -float(self.offset + self.double_delta))
        xs = np.empty(self.max_fg, np.int16)
        ys = np.empty(self.max_fg, np.int16)
        flags = np.zeros(self.max_fg, np.uint8)
        count = native.extract_fg_pixels(np.ascontiguousarray(mask),
                                         markers if markers is None else
                                         np.ascontiguousarray(markers),
                                         xs, ys, flags)
        if count is None:  # numpy fallback
            yy, xx = np.nonzero(mask)
            count = len(yy)
            m = min(count, self.max_fg)
            xs[:m] = xx[:m]
            ys[:m] = yy[:m]
            if markers is not None:
                flags[:m] = markers[yy[:m], xx[:m]] > 0
        if count > self.max_fg:
            with self._overflow_lock:
                self.overflowed += 1
            count = self.max_fg
        out = {'px_x': xs, 'px_y': ys, 'px_marker': flags, 'count': count}
        if self.include_luminosity:
            out['gray'] = np.ascontiguousarray(gray)
        if self.keep_frames:
            out['display_frames'] = np.ascontiguousarray(frame_bgr)
        return out
