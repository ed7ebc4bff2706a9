"""The live display of the PyTorch port ('display video analysis',
ysmr_tpu_torch/pipeline/display.py and its hooks in the stage-1 loop):
twins of tests/test_display.py, and the port against ysmr_tpu with a
fake GUI (cv2's window calls replaced): every frame drawn in both, the
same ids, positions within 1e-4 px (the device tracker's double-single
GSFF residue, tests/test_torch_track_bacteria.py)."""

import numpy as np
import pandas as pd
import pytest
import torch

from test_e2e_parity import _make_settings, make_synthetic_video

torch.set_num_threads(1)


def _dummy_settings():
    return {'debugging': True}


def _fake_batch(b=2, d=4, s=8):
    """tests/test_display.py's batch: two boxed detections and one track
    (id 7) a frame on black 48x64 frames."""
    det = {
        'det_xy': np.tile(np.array([[10.0, 12.0]]), (b, d, 1)),
        'det_info': np.tile(np.array([[6.0, 3.0, 30.0]]), (b, d, 1)),
        'det_valid': np.zeros((b, d), bool),
    }
    det['det_valid'][:, :2] = True
    emis = {
        'mask': np.zeros((b, s), bool),
        'ids': np.zeros((b, s), np.int32),
        'pos': np.zeros((b, s, 2), np.float32),
    }
    emis['mask'][:, 0] = True
    emis['ids'][:, 0] = 7
    emis['pos'][:, 0] = (10.0, 12.0)
    frames = np.zeros((b, 48, 64, 3), np.uint8)
    return frames, det, emis


def test_headless_display_disables(monkeypatch):
    from ysmr_tpu_torch.pipeline.display import LiveDisplay
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    disp = LiveDisplay('clip.avi', _dummy_settings(), 48, 64)
    assert not disp.enabled


def _fake_gui(monkeypatch, keys=None):
    """cv2's window calls recorded instead of shown; ``keys`` (an
    iterator) feeds waitKey, else no key is ever pressed."""
    import cv2
    monkeypatch.setenv('DISPLAY', ':0')
    shown = []
    monkeypatch.setattr(cv2, 'imshow', lambda name, img: shown.append(
        (name, img.copy())))
    monkeypatch.setattr(cv2, 'waitKey', (lambda ms: next(keys)) if keys
                        else (lambda ms: 255))
    monkeypatch.setattr(cv2, 'namedWindow', lambda *a, **k: None)
    monkeypatch.setattr(cv2, 'destroyAllWindows', lambda: None)
    return shown


def test_show_batch_draws_and_q_interrupts(monkeypatch):
    from ysmr_tpu_torch.pipeline import display as disp_mod
    shown = _fake_gui(monkeypatch, iter([255, ord('q')]))
    disp = disp_mod.LiveDisplay('clip.avi', {'debugging': False}, 48, 64)
    assert disp.enabled
    frames, det, emis = _fake_batch()
    disp.show_batch(frames, 2, det, emis, fps=42.0)
    assert disp.interrupted
    names = [n for n, _ in shown]
    assert names == ['clip.avi unfiltered possible detections'] * 2
    assert shown[0][1].any()


def test_show_batch_mask_windows_packed(monkeypatch):
    from ysmr_tpu_torch.pipeline import display as disp_mod
    shown = _fake_gui(monkeypatch)
    disp = disp_mod.LiveDisplay('clip.avi', {'debugging': True}, 48, 64)
    frames, det, emis = _fake_batch(b=1)
    det['px_packed'] = np.array([[3 * 64 + 5, (3 * 64 + 6) | (1 << 31)]],
                                np.uint32)
    det['count'] = np.array([2])
    disp.show_batch(frames, 1, det, emis, fps=1.0)
    names = [n for n, _ in shown]
    assert 'threshold (pre-propagation)' in names
    assert 'Adaptive double threshold markers' in names


def test_track_bacteria_headless_display_matches_plain(tmp_path,
                                                       monkeypatch):
    """With no GUI, 'display video analysis' (the default ini's) warns and
    changes nothing: the host-rect path runs as without it."""
    from ysmr_tpu_torch import track_bacteria
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    res = {}
    for name, disp in (('plain', False), ('disp', True)):
        out = tmp_path / name
        out.mkdir()
        res[name] = track_bacteria(
            video, settings=_make_settings(
                tmp_path, **{'display video analysis': disp}),
            result_folder=str(out), device='cpu')
        assert res[name] is not None
    pd.testing.assert_frame_equal(res['plain'][0], res['disp'][0])


def test_track_bacteria_display_fake_gui_and_interrupt(tmp_path,
                                                       monkeypatch):
    """Every frame is previewed; 'q' stops the run as a read error does
    (None, no list kept)."""
    from ysmr_tpu_torch import track_bacteria
    shown = _fake_gui(monkeypatch)
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    settings = _make_settings(tmp_path, **{'display video analysis': True})
    out_a = tmp_path / 'gui'
    out_a.mkdir()
    res = track_bacteria(video, settings=settings, result_folder=str(out_a),
                         device='cpu')
    assert res is not None
    main = [n for n, _ in shown if 'unfiltered possible detections' in n]
    assert len(main) == 40
    # 'q' on the tenth frame: the second batch of 8
    shown.clear()
    _fake_gui(monkeypatch, iter([255] * 9 + [ord('q')] * 100))
    out_b = tmp_path / 'gui_q'
    out_b.mkdir()
    assert track_bacteria(video, settings=settings, result_folder=str(out_b),
                          device='cpu') is None


def _display_rows(tmp_path, monkeypatch, fn, name, **kw):
    shown = _fake_gui(monkeypatch)
    video = str(tmp_path / 'clip.avi')
    out = tmp_path / name
    out.mkdir()
    res = fn(video, settings=_make_settings(
        tmp_path, **{'display video analysis': True}),
        result_folder=str(out), **kw)
    assert res is not None, name
    frames = [img for n, img in shown
              if 'unfiltered possible detections' in n]
    return res[0], frames


def test_display_rows_match_jax(tmp_path, monkeypatch):
    """The fake GUI on in both packages (the device-rect path, batches of
    8): both draw every frame, with the same detections boxed; ids are
    equal and positions within 1e-4 px."""
    from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
    from ysmr_tpu_torch import track_bacteria
    make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    jdf, jframes = _display_rows(tmp_path, monkeypatch, jtrack, 'jax')
    tdf, tframes = _display_rows(tmp_path, monkeypatch, track_bacteria,
                                 'torch', device='cpu')
    assert len(tframes) == len(jframes) == 40
    assert jdf.shape == tdf.shape and jdf.shape[0] > 100
    for col in ('TRACK_ID', 'POSITION_T', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE'):
        np.testing.assert_array_equal(tdf[col].to_numpy(),
                                      jdf[col].to_numpy(), err_msg=col)
    for col in ('POSITION_X', 'POSITION_Y'):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   atol=1e-4, rtol=0, err_msg=col)
    # the same boxes (blue) on every frame; text may move by a pixel where
    # a position's integer part differs
    for t, (a, b) in enumerate(zip(tframes, jframes)):
        blue = lambda img: (img[..., 0] == 255) & (img[..., 1] == 0)
        assert (blue(a) == blue(b)).mean() > 0.999, t


@pytest.mark.cuda
def test_display_on_cuda_equals_cpu(tmp_path, monkeypatch):
    """The display on the card: the host copies of the device tables draw
    every frame, and the rows are the CPU run's (positions within the
    device tracker's 1e-4 px)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from ysmr_tpu_torch import track_bacteria
    make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    cdf, cframes = _display_rows(tmp_path, monkeypatch, track_bacteria,
                                 'cuda')
    pdf, pframes = _display_rows(tmp_path, monkeypatch, track_bacteria,
                                 'cpu', device='cpu')
    assert len(cframes) == len(pframes) == 40
    assert cdf.shape == pdf.shape
    for col in ('TRACK_ID', 'POSITION_T'):
        np.testing.assert_array_equal(cdf[col].to_numpy(),
                                      pdf[col].to_numpy(), err_msg=col)
    for col in ('POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE'):
        np.testing.assert_allclose(cdf[col].to_numpy(), pdf[col].to_numpy(),
                                   atol=1e-4, rtol=0, err_msg=col)
