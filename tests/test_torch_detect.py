"""Frames-mode detection of the PyTorch port (ysmr_tpu_torch/pipeline/
detect.py) against ysmr_tpu/pipeline/detect.py on the same seeded BGR
frames.

``det_xy``, ``det_info``, ``det_valid`` and ``n_components`` are compared
bit for bit in every threshold mode: adaptive double, single adaptive,
mean (two batches, so the 5 s moving-average window carries over) and dark
bacteria, and with luminosity (the exact rect mean as the third det_xy
column). The JAX side runs its CPU path (XLA labeling, no Pallas).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import preprocess as jpp
from ysmr_tpu.pipeline import detect as jdet
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.pipeline import detect as det

torch.set_num_threads(1)

H, W, T = 72, 96, 4

SETTINGS = {
    'adaptive double threshold': 2.0,
    'threshold offset for detection': 5,
    'white bacteria on dark background': True,
    'max detections per frame': 24,
    'max bounding box height': 16,
    'connected components max iterations': 64,
    'include luminosity in tracking calculation': False,
    'luminosity window size': 48,
}

CASES = {
    'adaptive_double': {},
    'adaptive': {'adaptive double threshold': 0.0},
    'mean': {'adaptive double threshold': -1.0},
    'dark_bacteria': {'white bacteria on dark background': False,
                      'threshold offset for detection': 10},
    'over_capacity': {'max detections per frame': 3},
    'luminosity': {'include luminosity in tracking calculation': True},
    'luminosity_mean': {'include luminosity in tracking calculation': True,
                        'adaptive double threshold': -1.0},
}


def seeded_frames(seed, dark=False, t=T):
    """BGR frames with rotated rods over noise (bright rods, or dark ones
    on a light background)."""
    rng = np.random.default_rng(seed)
    bg, fg = (215, 55) if dark else (40, 200)
    out = np.zeros((t, H, W, 3), np.uint8)
    pos = rng.uniform(8, [W - 8, H - 8], (9, 2))
    for i in range(t):
        img = rng.normal(bg, 4, (H, W)).clip(0, 255).astype(np.uint8)
        for k, p in enumerate(pos + i):
            cv2.ellipse(img, (int(p[0]), int(p[1])), (4 + k % 3, 2),
                        float(20 * k + 7 * i), 0, 360, fg, -1)
        out[i] = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return out


def _assert_same(ours, ref):
    for key in ('det_xy', 'det_info', 'det_valid', 'n_components'):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize('case', sorted(CASES))
def test_detect_batch_matches_jax(case):
    settings = {**SETTINGS, **CASES[case]}
    cfg = det.DetectorConfig(settings)
    jcfg = jdet.DetectorConfig(settings, 30)
    state = jstate = None
    if cfg.mode == 'mean':
        state = pp.MovingAverageThreshold(1, cfg.offset, cfg.white_on_dark)
        jstate = jpp.MovingAverageThreshold(1, cfg.offset, cfg.white_on_dark)
    # the second batch is short: its padding frames detect nothing
    for batch, count in ((0, T), (1, T - 1)):
        frames = seeded_frames(batch + 3, dark=case == 'dark_bacteria')
        valid = np.arange(T) < count
        ours = det.detect_batch(torch.from_numpy(frames),
                                torch.from_numpy(valid), cfg,
                                threshold_state=state)
        ref = jdet.detect_batch(jnp.asarray(frames), jnp.asarray(valid),
                                jcfg, threshold_state=jstate,
                                use_pallas=False)
        _assert_same(ours, ref)
        assert ours['det_valid'][:count].sum(dim=1).min() > 0
        assert not ours['det_valid'][count:].any()
    if state is not None:
        assert state.window == jstate.window and len(state.window) > T
