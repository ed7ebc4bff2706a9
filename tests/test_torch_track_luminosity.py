"""Luminosity (the ILLUMINATION column) of the PyTorch port end to end
against the JAX package on the CPU: the synthetic clips of
tests/test_torch_track_bacteria.py through both track_bacteria functions
with 'include luminosity in tracking calculation'.

- Host rects (the default gate): the split pixel wire, per-pixel labels,
  cv2-exact host rects and their exact rect means on the device; without
  GSFF the float64 tracker in 3-D (``_list.csv`` bytes equal), with GSFF
  the device tracker on the host rects (positions within 1e-4 px).
- Device rects (frames mode, and pixels mode without cv2 rects): the
  exact rect mean at the exact rect center. The port's rect corners are
  OpenCV's float64 recipe, JAX's take XLA's float32 cos/sin; on the
  pinned rows JAX's corners cross a knife edge, and the port's value is
  cv2's recipe on that rect (on all 799 detections of the adaptive_double
  and dark_bacteria clips in frames mode the port equals cv2's recipe,
  JAX misses on 3).
"""

import numpy as np
import pytest
import torch

from test_torch_track_bacteria import CLIPS, FRAMES, LUM, _run_both
from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
from ysmr_tpu_torch import track_bacteria

torch.set_num_threads(1)


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_luminosity_list_csv_byte_identical_to_jax(tmp_path, clip):
    """Luminosity without GSFF: the split pixel wire, per-pixel labels,
    host rects, their exact rect means on the device and the float64
    tracker in 3-D give JAX's ``_list.csv`` bytes, ILLUMINATION included."""
    extra = {**LUM, 'disable gsff': True}
    out = _run_both(tmp_path, clip, runs=(('jax', jtrack, extra),
                                          ('torch', track_bacteria, extra)))
    (jres, jbytes), (tres, tbytes) = out['jax'], out['torch']
    assert jbytes.count(b'\n') > 100 and b'ILLUMINATION' in jbytes
    assert tbytes == jbytes
    assert tres[1:4] == jres[1:4]


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_luminosity_gsff_rows_match_jax(tmp_path, clip):
    """Luminosity with GSFF (the float64 tracker does not run it): host
    rects feed the device tracker in 3-D. TRACK_ID, POSITION_T, the rect
    columns and ILLUMINATION equal JAX's; positions within 1e-4 px (the
    tracker's double-single residue, tests/test_torch_tracker.py)."""
    out = _run_both(tmp_path, clip, runs=(('jax', jtrack, LUM),
                                          ('torch', track_bacteria, LUM)))
    jdf, tdf = out['jax'][0][0], out['torch'][0][0]
    assert jdf.shape == tdf.shape and jdf.shape[0] > 100
    for col in ('TRACK_ID', 'POSITION_T', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE', 'ILLUMINATION'):
        np.testing.assert_array_equal(tdf[col].to_numpy(),
                                      jdf[col].to_numpy(), err_msg=col)
    for col in ('POSITION_X', 'POSITION_Y'):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   atol=1e-4, rtol=0, err_msg=col)


#: rows whose ILLUMINATION differs from JAX's in the device-rect modes,
#: per (clip, mode): there the JAX corners of the exact rect (float32 angle
#: and XLA's float32 cos/sin inside the detect program) cross a knife
#: edge that the port's (OpenCV's float64 recipe) does not; the port's
#: value is cv2's recipe on that rect (ROADMAP Queue 3)
LUM_DEVICE_DIFFS = {('adaptive_double', 'frames'): 1,
                    ('adaptive_double', 'device_rects'): 1,
                    ('dark_bacteria', 'frames'): 2,
                    ('dark_bacteria', 'device_rects'): 2}


@pytest.mark.parametrize('mode', ['frames', 'device_rects'])
@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_luminosity_device_rects_match_jax(tmp_path, clip, mode):
    """Luminosity on the device rects (frames mode, and pixels mode with
    'cv2 exact rects' off): the exact rect mean at the exact center.
    TRACK_ID, POSITION_T and the rect columns equal JAX's, positions
    within the device tracker's tolerance (2e-4 px in frames mode, 1e-4
    px with cv2 centers), ILLUMINATION equal but on the pinned rows."""
    extra = {**LUM, **(FRAMES if mode == 'frames' else
                       {'cv2 exact rects': False})}
    out = _run_both(tmp_path, clip, runs=(('jax', jtrack, extra),
                                          ('torch', track_bacteria, extra)))
    jdf, tdf = out['jax'][0][0], out['torch'][0][0]
    assert jdf.shape == tdf.shape and jdf.shape[0] > 100
    for col in ('TRACK_ID', 'POSITION_T', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE'):
        np.testing.assert_array_equal(tdf[col].to_numpy(),
                                      jdf[col].to_numpy(), err_msg=col)
    gsff = not CLIPS[clip][1].get('disable gsff')
    tol = (2e-4 if mode == 'frames' else 1e-4) if gsff else 0
    for col in ('POSITION_X', 'POSITION_Y'):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   atol=tol, rtol=0, err_msg=col)
    diff = tdf['ILLUMINATION'].to_numpy() != jdf['ILLUMINATION'].to_numpy()
    assert int(diff.sum()) == LUM_DEVICE_DIFFS.get((clip, mode), 0)
