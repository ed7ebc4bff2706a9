"""The port's fast MJPG gray decode (``ysmr_tpu_torch/io/video.py``'s
``MjpgAviDemuxer``, ``io/preproc.py::process_jpeg``, ``native.py``'s
``decode_jpeg_gray_stage1``) against ``tests/test_fast_decode.py``'s
checks and against the JAX package.

Each test is the twin of the JAX package's test of the same name, run on
the port's demuxer, reader, native module and ``track_bacteria`` (on the
CPU); each also runs ``ysmr_tpu``'s counterpart on the same clip with the
same settings: the demuxers' chunks and gray frames, and every batch of
the two readers, must be array-equal. Fast mode's ``_list.csv`` is held
to ``ysmr_tpu``'s byte for byte (the JAX side with ``'run cc': 'on'``,
its CPU path's switch for the port's run-CC path), and fast mode's
``cv2.imdecode`` route (the per-frame decode where the native library
has no libjpeg, as on a host without ``jpeglib.h``) is held to the JAX
package's same route.

Tolerance: +-2 gray levels of fast against exact decode, and positions
within 0.25 px of the fast run's rows against the exact run's, as in the
JAX tests; none between the packages.
"""

import os

import numpy as np
import pytest

import decode_twins as dt
from test_e2e_parity import _make_settings, make_synthetic_video
from ysmr_tpu import native as jnative
from ysmr_tpu.io.video import BatchedVideoReader as JReader
from ysmr_tpu.io.video import MjpgAviDemuxer as JDemuxer
from ysmr_tpu.io.video import VideoReadError as JVideoReadError


def test_demuxer_frames_match_videocapture(tmp_path):
    import cv2
    from ysmr_tpu_torch.io.video import MjpgAviDemuxer
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=24)
    demux, jdemux = MjpgAviDemuxer(video), JDemuxer(video)
    assert demux.offsets == jdemux.offsets
    cap = cv2.VideoCapture(video)
    n = 0
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            b, g, r = [bgr[:, :, k].astype(np.int64) for k in range(3)]
            exact = ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15)
            fast = demux.read_gray(n)
            assert fast.shape == exact.shape
            delta = np.abs(fast.astype(int) - exact)
            assert delta.max() <= 2, delta.max()
            assert np.array_equal(fast, jdemux.read_gray(n))
            n += 1
    finally:
        cap.release()
        demux.close()
        jdemux.close()
    assert len(demux) == n == 24


def test_fast_mode_reader_yields_gray_tables(tmp_path):
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=16)
    settings = dt.settings(tmp_path)
    reader, jreader = dt.readers(video, settings, max_fg=4096, batch_size=8,
                                 decode_mode='fast')
    assert reader._demux is not None and jreader._demux is not None
    batches = dt.collect(reader)
    for _, _, frames in batches:
        key = 'px_packed' if 'px_packed' in frames else 'px_x'
        assert frames[key].shape == (8, 4096)
    assert sum(count for _, count, _ in batches) == 16
    dt.assert_batches_equal(batches, dt.collect(jreader))


def test_fast_mode_imdecode_route_matches_jax(tmp_path, monkeypatch):
    """Without the native libjpeg decode (``decode_jpeg_gray_stage1``
    unavailable) fast mode decodes each frame with ``cv2.imdecode`` and
    thresholds it on the host: the port's batches equal the JAX reader's
    on the same route, and every frame of them took it."""
    from ysmr_tpu_torch import native
    calls = {'torch': 0, 'jax': 0}

    def unavailable(name):
        def decode(*_args, **_kwargs):
            calls[name] += 1
        return decode

    monkeypatch.setattr(native, 'decode_jpeg_gray_stage1',
                        unavailable('torch'))
    monkeypatch.setattr(jnative, 'decode_jpeg_gray_stage1',
                        unavailable('jax'))
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=20)
    settings = dt.settings(tmp_path)
    reader, jreader = dt.readers(video, settings, max_fg=4096, batch_size=8,
                                 decode_mode='fast')
    assert reader._demux is not None and not reader._exact_fused
    batches = dt.collect(reader)
    assert calls['torch'] == 20
    dt.assert_batches_equal(batches, dt.collect(jreader))
    assert calls['jax'] == 20


def _track(fn, video, settings, folder, **kw):
    os.makedirs(folder)
    res = fn(video, settings=settings, result_folder=folder, **kw)
    assert res is not None, folder
    with open(res[4], 'rb') as f:
        return res[0], f.read()


def test_fast_mode_same_tracks_as_exact(tmp_path):
    """On a clean high-contrast scene the +-2 gray delta changes nothing."""
    from ysmr_tpu_torch import track_bacteria
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    results = {}
    for mode in ('exact', 'fast'):
        settings = _make_settings(tmp_path, **{'decode mode': mode})
        results[mode] = _track(track_bacteria, video, settings,
                               str(tmp_path / mode), device='cpu')[0]
    exact, fast = results['exact'], results['fast']
    assert exact['TRACK_ID'].nunique() == fast['TRACK_ID'].nunique()
    assert len(exact) == len(fast)
    np.testing.assert_allclose(fast['POSITION_X'], exact['POSITION_X'],
                               atol=0.25)
    np.testing.assert_allclose(fast['POSITION_Y'], exact['POSITION_Y'],
                               atol=0.25)


@pytest.mark.parametrize('threads', [1, 2])
def test_fast_mode_list_csv_byte_identical_to_jax(tmp_path, threads):
    """Fast mode's ``_list.csv`` of the port (sequential and striped
    decode) is ``ysmr_tpu``'s, byte for byte."""
    from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
    from ysmr_tpu_torch import track_bacteria
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40)
    settings = _make_settings(tmp_path, **{'decode mode': 'fast',
                                           'host decode threads': threads})
    tdf, tbytes = _track(track_bacteria, video, settings,
                         str(tmp_path / 'torch'), device='cpu')
    jdf, jbytes = _track(jtrack, video, {**settings, 'run cc': 'on'},
                         str(tmp_path / 'jax'))
    assert tbytes.count(b'\n') > 100
    assert tbytes == jbytes


def test_fast_mode_falls_back_for_truncated_avi(tmp_path):
    """A file with fewer readable chunks than the header claims is refused
    by the demuxer gate and decoded via the exact path instead."""
    from ysmr_tpu_torch.io.video import BatchedVideoReader
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=24)
    data = open(video, 'rb').read()
    cut = str(tmp_path / 'cut.avi')
    open(cut, 'wb').write(data[:int(len(data) * 0.6)])

    def pre(_frame):
        return {'count': 0, 'px_x': np.zeros(4, np.int16)}

    reader = BatchedVideoReader(cut, batch_size=4, preprocess=pre,
                                decode_mode='fast')
    jreader = JReader(cut, batch_size=4, preprocess=pre, decode_mode='fast')
    # either the demuxer found every frame the (truncated) header claims,
    # or it is disabled: never a crash, never silently short reads
    if reader._demux is not None:
        assert len(reader._demux) >= reader.frame_count
    assert (reader._demux is None) == (jreader._demux is None)
    assert reader.frame_count == jreader.frame_count
    dt.assert_batches_equal(dt.collect(reader), dt.collect(jreader))


def test_native_jpeg_decode_rejects_hostile_dims(tmp_path):
    """A JPEG whose header claims absurd dimensions fails cleanly (the
    dims cap / bad_alloc guard), not by killing the process."""
    from ysmr_tpu_torch import native
    from ysmr_tpu_torch.io.video import MjpgAviDemuxer
    if native._load() is None or \
            not hasattr(native._load(), 'decode_jpeg_gray_stage1'):
        pytest.skip('native jpeg decode unavailable')
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=2)
    demux = MjpgAviDemuxer(video)
    chunk = np.array(demux.chunk(0))
    demux.close()
    # the pristine chunk decodes, with the JAX package's dims and stats
    got = native.decode_jpeg_gray_stage1(chunk, need_mean=False,
                                         want_stats=True)
    want = jnative.decode_jpeg_gray_stage1(chunk, need_mean=False,
                                           want_stats=True)
    assert got is not None and got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    # the SOF0 height and width patched to 65535 x 65535 (past the cap)
    bad = chunk.copy()
    i = 0
    patched = False
    while i + 9 < len(bad):
        if bad[i] == 0xFF and bad[i + 1] in (0xC0, 0xC1, 0xC2):
            bad[i + 5:i + 9] = [0xFF, 0xFF, 0xFF, 0xFF]  # height, width
            patched = True
            break
        i += 1
    assert patched, 'no SOF marker found'
    assert native.decode_jpeg_gray_stage1(bad, need_mean=False) is None
    assert jnative.decode_jpeg_gray_stage1(bad, need_mean=False) is None


def test_demuxer_rejects_non_avi(tmp_path):
    from ysmr_tpu_torch.io.video import MjpgAviDemuxer, VideoReadError
    bad = str(tmp_path / 'not.avi')
    open(bad, 'wb').write(b'RIFF....WAVEdata' + b'\0' * 64)
    with pytest.raises(VideoReadError):
        MjpgAviDemuxer(bad)
    with pytest.raises(JVideoReadError):
        JDemuxer(bad)


def test_fast_mode_falls_back_for_non_mjpg(tmp_path):
    """Non-MJPG input silently uses the exact decoder."""
    import cv2
    video = str(tmp_path / 'raw.avi')
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'FFV1'), 30,
                             (64, 48))
    if not writer.isOpened():  # codec unavailable: nothing to test
        pytest.skip('FFV1 encoder unavailable')
    rng = np.random.default_rng(0)
    for _ in range(8):
        writer.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    settings = dt.settings(tmp_path)
    reader, jreader = dt.readers(video, settings, max_fg=4096, batch_size=4,
                                 decode_mode='fast')
    assert reader._demux is None and jreader._demux is None
    dt.assert_batches_equal(dt.collect(reader), dt.collect(jreader))
