# Copied from ysmr_tpu/ops/gsff.py (the float64 filter-bank parameters only).
"""Gaussian-Sum FIR filter-bank parameters for the native float64 tracker.

Copied from ``ysmr_tpu/ops/gsff.py`` (``generate_n_i``, ``compute_lsf_gain``
and ``GSFFParams`` without its device-side double-single gain arrays). The
filter itself runs in ``native/tracker64.cpp`` on the host.
"""

import numpy as np


def generate_n_i(n_min=0, n_max=30, n_f=3):
    """Filter horizon sizes, Eq. 17 (gsff.py:86-109)."""
    p = (n_max - n_min) / n_f
    return [int(n_min + p * i) for i in range(1, n_f + 1)]


def compute_lsf_gain(filter_size, delta_time, a=None, c=None):
    """Least-squares FIR gain for one horizon, Eq. 13/14 (gsff.py:111-153).

    Constant-velocity state model A (4x4) and position observation C (2x4).
    :return: (4, 2*filter_size) float64 gain
    """
    if a is None:
        a = np.array([[1, 0, delta_time, 0],
                      [0, 1, 0, delta_time],
                      [0, 0, 1, 0],
                      [0, 0, 0, 1]], dtype=np.float64)
    if c is None:
        c = np.array([[1, 0, 0, 0],
                      [0, 1, 0, 0]], dtype=np.float64)
    h_bar = c
    a_n = a
    for _ in range(filter_size - 1):
        h_bar = np.concatenate((h_bar, np.dot(c, a_n)), axis=0)
        a_n = np.dot(a_n, a)
    l_bar = np.dot(h_bar, np.linalg.matrix_power(np.linalg.inv(a), filter_size))
    return np.dot(np.linalg.inv(np.dot(l_bar.T, l_bar)), l_bar.T)


class GSFFParams:
    """Precomputed, padded filter-bank parameters (static per video)."""

    def __init__(self, fps, n_min=0, n_max=None, n_f=3):
        if n_max is None:
            n_max = int(fps)
        self.n_f = n_f
        self.n_i = generate_n_i(n_min=n_min, n_max=n_max, n_f=n_f)
        self.n_max = self.n_i[-1]
        self.buf_len = self.n_max + 1
        delta_t = 1.0 / fps
        # gains right-aligned into (n_f, 2, 2*n_max): gain_i consumes the last
        # n_i measurements of the flattened oldest-first window; only the
        # first two state rows (position) are ever used downstream.
        gains = np.zeros((n_f, 2, 2 * self.n_max), dtype=np.float64)
        for i, n in enumerate(self.n_i):
            if n < 1:
                continue
            g = compute_lsf_gain(n, delta_t)
            gains[i, :, 2 * (self.n_max - n):] = g[:2]
        #: float64 right-aligned gains, consumed directly by the native f64
        #: host tracker (native/tracker64.cpp)
        self.gains_f64 = gains
