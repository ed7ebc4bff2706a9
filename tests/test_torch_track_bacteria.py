"""Stage 1 of the PyTorch port against the JAX package, end to end on the
CPU: the same synthetic clip and settings through both track_bacteria
functions.

- Host-rect path (the default below the capacity gate): byte-identical
  ``_list.csv`` files.
- Device-tracker path (``'cv2 exact rects': False``, the path of dense
  scenes): identical TRACK_ID, POSITION_T, WIDTH, HEIGHT and
  DEGREES_ANGLE; positions within 1e-4 px, the double-single GSFF
  tolerance of tests/test_torch_tracker.py (without GSFF they are equal).

The JAX side runs the same path as the port (pixels mode, runs wire, run
CC); on the CPU it only turns run CC on when asked, hence
``'run cc': 'on'``.

Frames mode (``'transfer mode': 'frames'``: device preprocess, whole-frame
labeling, device rects without the cv2-center override, device tracker)
against JAX frames mode: identical TRACK_ID, POSITION_T, WIDTH, HEIGHT and
DEGREES_ANGLE (the detections are bit-equal, tests/test_torch_detect.py);
positions within 2e-4 px with GSFF and equal without. The GSFF tolerance
is the tracker's double-single residue on exact (not cv2) centers:
measured 1.37e-4 px, nine float32 ulps of a 219 px coordinate, on one row
of the adaptive_double clip, the other rows within 1e-4 px; the two
packages' pixels modes without cv2 centers differ on that row by the same
amount, so the residue is the tracker's, not frames mode's. Frames
mode also gives the same ``_list.csv`` bytes as the port's pixels mode on
the device-rect path without cv2 centers, as the two JAX modes do.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from test_e2e_parity import _make_settings, make_synthetic_video
from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
from ysmr_tpu_torch import track_bacteria
from ysmr_tpu_torch.pipeline.track_bacteria import _track_loop

torch.set_num_threads(1)

N_FRAMES = 40

CLIPS = {
    'adaptive_double': (dict(seed=7), {}),
    'mean_threshold_no_gsff': (dict(seed=11), {
        'adaptive double threshold': -1.0, 'disable gsff': True}),
    'dark_bacteria': (dict(seed=19, dark_bacteria=True), {
        'white bacteria on dark background': False,
        'threshold offset for detection': 10}),
}


def _run_both(tmp_path, clip, runs=None, **more):
    video_kw, overrides = CLIPS[clip]
    overrides = {**overrides, **more}
    video = make_synthetic_video(str(tmp_path / 'clip.avi'),
                                 n_frames=N_FRAMES, **video_kw)
    settings = _make_settings(tmp_path, **overrides)
    out = {}
    for name, fn, extra in runs or (('jax', jtrack, {'run cc': 'on'}),
                                    ('torch', track_bacteria, {})):
        folder = str(tmp_path / name)
        os.makedirs(folder)
        kw = {'device': 'cpu'} if name.startswith('torch') else {}
        res = fn(video, settings={**settings, **extra}, result_folder=folder,
                 **kw)
        assert res is not None, name
        with open(res[4], 'rb') as f:
            out[name] = (res, f.read())
    return out


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_list_csv_byte_identical_to_jax(tmp_path, clip):
    out = _run_both(tmp_path, clip)
    (jres, jbytes), (tres, tbytes) = out['jax'], out['torch']
    assert jbytes.count(b'\n') > 100
    assert tbytes == jbytes
    pd.testing.assert_frame_equal(tres[0], jres[0])
    assert tres[1:4] == jres[1:4]
    assert os.path.basename(tres[4]) == os.path.basename(jres[4])


def test_exact_mode_above_the_default_gate(tmp_path):
    """Dense exact mode: with 'cv2 exact rects max detections' raised to a
    capacity above the default gate of 1024, the host rects and the
    float64 tracker run at that capacity; the ``_list.csv`` is JAX's, byte
    for byte, and the default gate's."""
    from ysmr_tpu_torch.pipeline.track_bacteria import use_host_rects
    exact = {'max detections per frame': 2048, 'max track slots': 2048,
             'cv2 exact rects max detections': 2048}
    settings = _make_settings(tmp_path, **exact)
    assert use_host_rects(settings)
    assert not use_host_rects({**settings,
                               'cv2 exact rects max detections': 1024})
    out = _run_both(tmp_path, 'adaptive_double', runs=(
        ('jax', jtrack, {**exact, 'run cc': 'on'}),
        ('torch', track_bacteria, exact),
        ('torch_default', track_bacteria, {})))
    assert out['jax'][1].count(b'\n') > 100
    assert out['torch'][1] == out['jax'][1]
    assert out['torch_default'][1] == out['jax'][1]


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_device_tracker_rows_match_jax(tmp_path, clip):
    out = _run_both(tmp_path, clip, **{'cv2 exact rects': False})
    (jres, _), (tres, _) = out['jax'], out['torch']
    jdf, tdf = jres[0], tres[0]
    assert jdf.shape == tdf.shape and jdf.shape[0] > 100
    for col in ('TRACK_ID', 'POSITION_T', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE'):
        np.testing.assert_array_equal(tdf[col].to_numpy(),
                                      jdf[col].to_numpy(), err_msg=col)
    tol = 0 if CLIPS[clip][1].get('disable gsff') else 1e-4
    for col in ('POSITION_X', 'POSITION_Y'):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   atol=tol, rtol=0, err_msg=col)
    assert tres[1:4] == jres[1:4]


FRAMES = {'transfer mode': 'frames'}
LUM = {'include luminosity in tracking calculation': True}


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_frames_mode_rows_match_jax(tmp_path, clip):
    out = _run_both(tmp_path, clip, runs=(('jax', jtrack, FRAMES),
                                          ('torch', track_bacteria, FRAMES)))
    (jres, _), (tres, _) = out['jax'], out['torch']
    jdf, tdf = jres[0], tres[0]
    assert jdf.shape == tdf.shape and jdf.shape[0] > 100
    for col in ('TRACK_ID', 'POSITION_T', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE'):
        np.testing.assert_array_equal(tdf[col].to_numpy(),
                                      jdf[col].to_numpy(), err_msg=col)
    tol = 0 if CLIPS[clip][1].get('disable gsff') else 2e-4
    for col in ('POSITION_X', 'POSITION_Y'):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   atol=tol, rtol=0, err_msg=col)
    assert tres[1:4] == jres[1:4]


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_frames_mode_equals_pixels_mode_without_cv2_centers(tmp_path, clip):
    pixels = {'cv2 exact rects': False, 'cv2 exact centers': 'off'}
    out = _run_both(tmp_path, clip, runs=(
        ('torch_frames', track_bacteria, FRAMES),
        ('torch_pixels', track_bacteria, pixels)))
    (fres, fbytes), (pres, pbytes) = out['torch_frames'], out['torch_pixels']
    assert fbytes.count(b'\n') > 100
    assert fbytes == pbytes
    assert fres[1:4] == pres[1:4]


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_pixel_table_wires_equal_run_cc(tmp_path, clip):
    """'run cc = off' (the run wire expanded to per-pixel labels) and
    'wire format = pixels' give the run-CC path's ``_list.csv`` bytes."""
    out = _run_both(tmp_path, clip, runs=(
        ('torch_runcc', track_bacteria, {}),
        ('torch_off', track_bacteria, {'run cc': 'off'}),
        ('torch_pixels', track_bacteria, {'wire format': 'pixels'})))
    base = out['torch_runcc'][1]
    assert base.count(b'\n') > 100
    assert out['torch_off'][1] == base and out['torch_pixels'][1] == base


def test_slice_gate_and_unported_settings(tmp_path):
    """The capacity gate picks the path; luminosity (both transfer modes),
    the pixel wire, 'run cc = off', the live display and the compact
    emissions readback are ported, and so is 'use table cc', the last
    setting the port refused: it runs, and on the run wire, whose run-CC
    branch ignores it as ``ysmr_tpu``'s does, gives the same bytes."""
    from ysmr_tpu_torch.pipeline.track_bacteria import use_host_rects
    settings = _make_settings(tmp_path)
    assert use_host_rects(settings)
    assert not use_host_rects({**settings, 'cv2 exact rects': False})
    assert not use_host_rects({**settings,
                               'max detections per frame': 4096})
    # frames mode is ported and always takes the device tracker
    assert not use_host_rects({**settings, **FRAMES})
    assert use_host_rects({**settings, **LUM})
    # an open display shuts the host-rect gate
    assert not use_host_rects(settings, has_display=True)
    out = _run_both(tmp_path, 'adaptive_double', runs=(
        ('torch', track_bacteria, {}),
        ('torch_table', track_bacteria, {'use table cc': True})))
    assert out['torch'][1].count(b'\n') > 100
    assert out['torch_table'][1] == out['torch'][1]


def test_track_loop_with_in_memory_reader(tmp_path):
    """The loop takes any reader with the BatchedVideoReader attributes:
    frames made in numpy, thresholded by the port's HostPreprocessor, give
    the same rows as the same frames read back from a lossless file."""
    import cv2
    from ysmr_tpu_torch.io.preproc import HostPreprocessor
    from ysmr_tpu_torch.utils.csv_io import save_list

    rng = np.random.default_rng(2)
    h, w, n, bs = 96, 128, 36, 8
    frames = []
    pos = rng.uniform(20, [w - 20, h - 20], (6, 2))
    for t in range(n):
        img = rng.normal(40, 4, (h, w)).clip(0, 255).astype(np.uint8)
        for i, p in enumerate(pos + 0.3 * t):
            cv2.ellipse(img, (int(p[0]), int(p[1])), (4, 2), 30.0 * i, 0,
                        360, 200, -1)
        frames.append(img)
    settings = _make_settings(tmp_path)
    settings['frame batch size'] = bs

    class Reader:
        width, height, fps, frame_count, batch_size = w, h, 30.0, n, bs

        def __init__(self):
            self.preprocess = HostPreprocessor(settings, 30.0, max_fg=4096)

        def __iter__(self):
            for s in range(0, n, bs):
                tabs = [self.preprocess(f) for f in frames[s:s + bs]]
                batch = {'count': np.zeros(bs, np.int32),
                         'px_packed': np.zeros((bs, 4096), np.uint32)}
                for i, tab in enumerate(tabs):
                    batch['count'][i] = tab['count']
                    batch['px_packed'][i] = tab['px_packed']
                yield {'frames': batch, 'start': s, 'count': len(tabs)}

    _, list_name = save_list(path=str(tmp_path / 'mem.avi'),
                             result_folder=str(tmp_path), first_call=True)
    stats = {}
    res = _track_loop(Reader(), settings, 30.0, list_name,
                      device=torch.device('cpu'), stats=stats)
    assert res is not None
    assert stats['frames'] == n and stats['capped_frames'] == 0
    df = res[0]
    assert df['POSITION_T'].nunique() == n
    assert df['TRACK_ID'].nunique() == 6


def test_profiler_dir_writes_a_trace(tmp_path, monkeypatch):
    """``jax profiler dir`` (the key both packages read): the port wraps
    the tracking run in ``torch.profiler`` and writes a Chrome trace into
    the directory, after a run that ends normally and after one that
    fails; the run's rows are those of a run without it."""
    import json
    import ysmr_tpu_torch.pipeline.track_bacteria as tb

    video = make_synthetic_video(str(tmp_path / 'clip.avi'),
                                 n_frames=N_FRAMES, seed=7)
    trace_dir = tmp_path / 'traces'
    settings = _make_settings(tmp_path)
    rows = {}
    for name, extra in (('plain', {}),
                        ('traced', {'jax profiler dir': str(trace_dir)})):
        folder = str(tmp_path / name)
        os.makedirs(folder)
        res = track_bacteria(video, settings={**settings, **extra},
                             result_folder=folder, device='cpu')
        assert res is not None
        with open(res[4], 'rb') as f:
            rows[name] = f.read()
    assert rows['traced'] == rows['plain']
    traces = sorted(trace_dir.iterdir())
    assert [p.name.startswith('clip.') and p.name.endswith('.pt.trace.json')
            for p in traces] == [True]
    assert traces[0].stat().st_size > 0
    with open(traces[0]) as f:
        assert json.load(f)['traceEvents']

    def failing_loop(*args, **kwargs):
        raise RuntimeError('read failed')

    monkeypatch.setattr(tb, '_track_loop', failing_loop)
    folder = str(tmp_path / 'failed')
    os.makedirs(folder)
    with pytest.raises(RuntimeError, match='read failed'):
        track_bacteria(video, settings={**settings,
                                        'jax profiler dir': str(trace_dir)},
                       result_folder=folder, device='cpu')
    assert len(list(trace_dir.iterdir())) == 2
