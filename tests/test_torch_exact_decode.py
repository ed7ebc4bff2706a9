"""The port's exact decode (``ysmr_tpu_torch/io/video.py``,
``io/preproc.py::process_jpeg_exact``, ``native.py``'s avdec entries)
against ``tests/test_exact_decode.py``'s checks and against the JAX
package.

Each test is the twin of the JAX package's test of the same name, run on
the port's reader and native module; each also runs ``ysmr_tpu``'s reader
on the same clip with the same settings, and every batch of the two must
be array-equal (start, count and each pixel-table field). Both packages
load the same ``native/libysmr_avdec.so`` into the process, so its
counters (the gray LUT's and the first-party decoder's frames) are read
around the port's reader alone. Skips where the JAX tests skip: no avdec
module, no first-party decoder in it, the fused path inactive.

Tolerance: none. Frames and tables are bytes.
"""

import numpy as np
import pytest

import decode_twins as dt
from test_e2e_parity import make_synthetic_video
from ysmr_tpu import native as jnative
from ysmr_tpu.io.video import MjpgAviDemuxer as JDemuxer


KW = dict(max_fg=4096, batch_size=8, decode_mode='exact', threaded=False)


def _readers(video, settings, force_cv2=False):
    return dt.readers(video, settings, force_cv2=force_cv2, **KW)


def _reader(video, settings, force_cv2=False):
    """The port's reader alone."""
    return dt.reader(video, settings, force_cv2=force_cv2, **KW)


def _jax_batches(video, settings):
    """The JAX reader's batches; made after the port's reader has run, so
    that its self-check frame stays out of the port's counts."""
    return dt.collect(dt.reader(video, settings, jax=True, **KW))


def _avdec_or_skip():
    from ysmr_tpu_torch import native
    if not native.avdec_available():
        pytest.skip('avdec module not built')
    return native


def _jdec_or_skip(native):
    if not getattr(native._load_avdec(), '_has_jdec', False):
        pytest.skip('jdec entry points absent in this build')


def _same_as_cv2_and_jax(batches, video, settings):
    """The port's fused batches, held to its cv2 path's (the exact fused
    decode off) and to the JAX reader's."""
    dt.assert_batches_equal(
        batches, dt.collect(_reader(video, settings, force_cv2=True)))
    dt.assert_batches_equal(batches, _jax_batches(video, settings))


def _same_as_jax(reader, jreader):
    """The port's batches, held to the JAX reader's."""
    got = dt.collect(reader)
    dt.assert_batches_equal(got, dt.collect(jreader))
    return got


def test_avdec_frames_byte_identical_to_videocapture(tmp_path):
    import cv2
    native = _avdec_or_skip()
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
            chunk = demux.chunk(n)
            assert bytes(chunk) == bytes(jdemux.chunk(n))
            ours = native.avdec_decode_bgr(chunk)
            assert ours is not None
            assert np.array_equal(ours, bgr), 'frame {} differs'.format(n)
            assert np.array_equal(ours, jnative.avdec_decode_bgr(chunk))
            n += 1
    finally:
        cap.release()
        demux.close()
        jdemux.close()
    assert n == 24


def test_exact_fused_reader_batches_byte_identical(tmp_path):
    _avdec_or_skip()
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=20)
    settings = dt.settings(tmp_path)
    fused, jfused = _readers(video, settings)
    assert fused._exact_fused and jfused._exact_fused, \
        'self-check should pass on this system'
    plain, jplain = _readers(video, settings, force_cv2=True)
    assert not plain._exact_fused and not jplain._exact_fused
    batches_a = _same_as_jax(fused, jfused)
    batches_b = _same_as_jax(plain, jplain)
    dt.assert_batches_equal(batches_a, batches_b)


def test_exact_fused_mean_mode_matches_cv2_path(tmp_path):
    # mean-threshold mode orders stats-before-threshold across the frame;
    # the fused path must keep that order (process_jpeg_exact's want_stats)
    _avdec_or_skip()
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=12)
    settings = dt.settings(tmp_path, {'adaptive double threshold': -1})
    fused, jfused = _readers(video, settings)
    plain = _reader(video, settings, force_cv2=True)
    if not fused._exact_fused:
        pytest.skip('fused path inactive for this configuration')
    assert fused.preprocess.threshold_state is not None
    dt.assert_batches_equal(_same_as_jax(fused, jfused), dt.collect(plain))


def make_color_video(path, n_frames=12, w=384, h=288):
    """A clip with real colour (chroma takes many values), so that the
    gray-content LUT path declines every frame."""
    import cv2
    rng = np.random.default_rng(3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 30,
                             (w, h))
    assert writer.isOpened()
    for t in range(n_frames):
        frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.circle(frame, (w // 2 + t, h // 2), 40, (255, 64, 0), -1)
        writer.write(frame)
    writer.release()
    return path


def test_gray_content_lut_fast_path_engages(tmp_path):
    # gray MJPG content decodes to chroma planes of at most 2 values; after
    # the runtime proof (native/avdec.cpp prove_gray_identity) frames skip
    # swscale through the LUT and stay byte-exact
    native = _avdec_or_skip()
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=16)
    settings = dt.settings(tmp_path)
    before, _ = native.avdec_gray_fast_stats()
    before_jdec = native.avdec_jdec_frames()
    reader = _reader(video, settings)
    if not reader._exact_fused:
        pytest.skip('fused path inactive on this system')
    batches = dt.collect(reader)
    after, status = native.avdec_gray_fast_stats()
    served_jdec = native.avdec_jdec_frames() - before_jdec
    assert sum(count for _, count, _ in batches) == 16
    assert status == 1, 'LUT identity should be provable on this system'
    # every fused frame takes a gray fast path: the avcodec + LUT route or
    # the first-party decoder (which fuses the same LUT); the self-check
    # frame always takes the LUT route
    served_lut = after - before
    assert served_lut >= 1
    assert served_lut + served_jdec >= 16
    dt.assert_batches_equal(batches, _jax_batches(video, settings))


def test_color_content_declines_lut_and_stays_exact(tmp_path):
    native = _avdec_or_skip()
    video = make_color_video(str(tmp_path / 'color.avi'))
    settings = dt.settings(tmp_path)
    before, _ = native.avdec_gray_fast_stats()
    fused = _reader(video, settings)
    if not fused._exact_fused:
        pytest.skip('fused path inactive on this system')
    batches = dt.collect(fused)
    after, _ = native.avdec_gray_fast_stats()
    assert after == before, 'color frames must take the full swscale path'
    _same_as_cv2_and_jax(batches, video, settings)


def test_self_check_failure_falls_back_to_cv2(tmp_path, monkeypatch):
    native = _avdec_or_skip()
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=12)
    settings = dt.settings(tmp_path)

    def bad_decode(_chunk):
        return np.zeros((4, 4, 3), np.uint8)

    monkeypatch.setattr(native, 'avdec_decode_bgr', bad_decode)
    monkeypatch.setattr(jnative, 'avdec_decode_bgr', bad_decode)
    reader, jreader = _readers(video, settings)
    assert not reader._exact_fused and not jreader._exact_fused
    assert reader._demux is None and jreader._demux is None
    batches = _same_as_jax(reader, jreader)
    assert sum(count for _, count, _ in batches) == 12


def test_per_frame_fallback_decode_matches_cap(tmp_path):
    # a frame the fused path declines mid-run comes out of the full-BGR
    # avdec fallback, never libjpeg (which is not bit-exact)
    import cv2
    _avdec_or_skip()
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=6)
    settings = dt.settings(tmp_path)
    reader, jreader = _readers(video, settings)
    if not reader._exact_fused:
        pytest.skip('fused path inactive')
    frame = reader._decode_chunk_frame(3)
    cap = cv2.VideoCapture(video)
    for _ in range(4):
        ok, ref = cap.read()
    cap.release()
    assert ok and np.array_equal(frame, ref)
    assert np.array_equal(frame, jreader._decode_chunk_frame(3))


def test_jdec_first_party_decoder_engages_and_is_exact(tmp_path):
    # the first-party MJPEG decoder (native/avdec.cpp's jdec block) serves
    # gray-content frames once its preconditions arm (a proven gray LUT, a
    # located idct_put) and stays byte-identical to the cv2 path
    native = _avdec_or_skip()
    _jdec_or_skip(native)
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=16)
    settings = dt.settings(tmp_path)
    before = native.avdec_jdec_frames()
    fused = _reader(video, settings)
    if not fused._exact_fused:
        pytest.skip('fused path inactive on this system')
    batches = dt.collect(fused)
    after = native.avdec_jdec_frames()
    if native._jdec_disabled:
        pytest.fail('jdec kill switch tripped: first-serve byte-compare '
                    'vs the avcodec path failed')
    # the LUT proof arms during the self-check frame, so every fused frame
    # after it may take the first-party decoder
    assert after - before >= 15
    _same_as_cv2_and_jax(batches, video, settings)


def test_jdec_declines_color_content(tmp_path):
    native = _avdec_or_skip()
    _jdec_or_skip(native)
    video = make_color_video(str(tmp_path / 'color.avi'))
    settings = dt.settings(tmp_path)
    before = native.avdec_jdec_frames()
    fused = _reader(video, settings)
    if not fused._exact_fused:
        pytest.skip('fused path inactive on this system')
    batches = dt.collect(fused)
    assert native.avdec_jdec_frames() == before, \
        'color frames must decline jdec (no proven gray LUT applies)'
    _same_as_cv2_and_jax(batches, video, settings)


def test_jdec_kill_switch_on_mismatch(tmp_path, monkeypatch):
    # if the first-party decoder's first served frame disagreed with the
    # avcodec path, the process-wide kill switch trips and the output stays
    # exact through the fallback: the JAX reader's batches
    native = _avdec_or_skip()
    _jdec_or_skip(native)
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=8)
    settings = dt.settings(tmp_path)
    monkeypatch.setattr(native, '_jdec_verified', set())
    monkeypatch.setattr(native, '_jdec_disabled', False)
    real = native.avdec_decode_gray

    def corrupted(chunk):
        out = real(chunk)
        if out is not None:
            out = out.copy()
            out[0, 0] ^= 1
        return out

    # patch only after construction: the reader's own self-check also
    # calls avdec_decode_gray and must see the real output
    fused, jfused = _readers(video, settings)
    if not fused._exact_fused:
        pytest.skip('fused path inactive on this system')
    monkeypatch.setattr(native, 'avdec_decode_gray', corrupted)
    batches = dt.collect(fused)
    assert native._jdec_disabled, \
        'a first-serve mismatch must trip the kill switch'
    dt.assert_batches_equal(batches, dt.collect(jfused))


def test_cv2_ffmpeg_lookup_finds_each_wheel_folder(tmp_path):
    """The exact fused decode loads cv2's own libavcodec and libswscale:
    the port looks in ``opencv_python.libs`` first, as ``ysmr_tpu`` does
    (the same files on this host), then in the other opencv wheels'
    folders (``opencv_python_headless.libs``, the H100 host's cv2);
    a folder without both libraries does not count."""
    import os

    from ysmr_tpu_torch import native

    def wheel(site, folder, names):
        os.makedirs(site / folder)
        for name in names:
            (site / folder / name).write_bytes(b'')
        return [str(site / folder / n).encode() for n in names]

    both = ('libavcodec-1.so.62', 'libswscale-2.so.9')
    site = tmp_path / 'a'
    headless = wheel(site, 'opencv_python_headless.libs', both)
    assert native._cv2_bundled_ffmpeg(str(site)) == tuple(headless)
    plain = wheel(site, 'opencv_python.libs', both)
    assert native._cv2_bundled_ffmpeg(str(site)) == tuple(plain)
    site = tmp_path / 'b'
    wheel(site, 'opencv_python_headless.libs', both[:1])
    assert native._cv2_bundled_ffmpeg(str(site)) == (None, None)
    assert native._cv2_bundled_ffmpeg(str(tmp_path / 'c')) == (None, None)
    got = native._cv2_bundled_ffmpeg()
    want = jnative._cv2_bundled_ffmpeg()
    assert [p and os.path.realpath(p) for p in got] == \
        [p and os.path.realpath(p) for p in want]
