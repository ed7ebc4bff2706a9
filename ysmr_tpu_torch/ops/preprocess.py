# Copied from ysmr_tpu/ops/preprocess.py (the host helpers only).
"""Host-side threshold helpers of the detection settings (numpy only).

Copied from ``ysmr_tpu/ops/preprocess.py`` (``MovingAverageThreshold``,
``detect_mode_from_settings``, ``resolve_detection_rule``,
``effective_threshold_offset``), unchanged. The device stencils of that
module belong to frames mode and are not ported yet.
"""

import math

import numpy as np


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
