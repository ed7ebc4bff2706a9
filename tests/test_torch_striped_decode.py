"""The port's striped decode (``ysmr_tpu_torch/io/video.py``:
``BatchedVideoReader(decode_threads=N)``, ``_resolve_stripes``,
``_iter_striped``) against ``tests/test_striped_decode.py``'s checks and
against the JAX package.

Each test is the twin of the JAX package's test of the same name on the
port's reader: striped batches identical to the sequential path's, the
same counts and error semantics, for every decode mode. Each also runs
``ysmr_tpu``'s reader with the same arguments (and the same header
patches), which must make the same number of stripes and give
array-equal batches: the exact fused decode striped, fast decode
striped, and mean-threshold mode, which its gate keeps sequential.

Tolerance: none. Frames and tables are bytes.
"""

import numpy as np
import pytest

import decode_twins as dt
from test_e2e_parity import make_synthetic_video
from ysmr_tpu.io.video import VideoReadError as JVideoReadError


def _same_as_jax(reader, jreader):
    """The port's batches, held to the JAX reader's (the same stripes)."""
    assert reader._n_stripes == jreader._n_stripes
    got = dt.collect(reader)
    dt.assert_batches_equal(got, dt.collect(jreader))
    assert reader.frames_read == jreader.frames_read
    assert reader.error_during_read == jreader.error_during_read
    return got


@pytest.mark.parametrize('batch_size', [8, 16])
def test_striped_exact_frames_identical(tmp_path, batch_size):
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=30)
    seq = dt.collect(dt.reader(video, batch_size=batch_size))
    reader, jreader = dt.readers(video, batch_size=batch_size,
                                 decode_threads=3)
    assert reader._n_stripes == min(3, -(-30 // batch_size))
    par = _same_as_jax(reader, jreader)
    dt.assert_batches_equal(seq, par)
    assert reader.frames_read == 30
    assert not reader.error_during_read


def test_striped_exact_pixels_identical(tmp_path):
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=25)
    settings = dt.settings(tmp_path)
    seq = dt.collect(dt.reader(video, settings, batch_size=8))
    reader, jreader = dt.readers(video, settings, batch_size=8,
                                 decode_threads=4)
    assert reader._n_stripes == 4
    assert reader._exact_fused == jreader._exact_fused
    par = _same_as_jax(reader, jreader)
    dt.assert_batches_equal(seq, par)
    assert reader.frames_read == 25


def test_striped_fast_demux_identical(tmp_path):
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=25)
    settings = dt.settings(tmp_path)
    seq_reader = dt.reader(video, settings, batch_size=8,
                           decode_mode='fast')
    assert seq_reader._demux is not None
    seq = dt.collect(seq_reader)
    reader, jreader = dt.readers(video, settings, batch_size=8,
                                 decode_mode='fast', decode_threads=3)
    assert reader._demux is not None and reader._n_stripes == 3
    par = _same_as_jax(reader, jreader)
    dt.assert_batches_equal(seq, par)
    assert reader.frames_read == 25


def test_striped_gates_off_for_mean_mode(tmp_path):
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=10)
    # mean mode keeps a frame-ordered moving average: it stays sequential
    settings = dt.settings(tmp_path, {'adaptive double threshold': -1.0})
    reader, jreader = dt.readers(video, settings, batch_size=8,
                                 decode_threads=4)
    assert reader.preprocess.threshold_state is not None
    assert reader._n_stripes == 1
    _same_as_jax(reader, jreader)


def test_striped_gates_off_for_non_mjpg(tmp_path):
    import cv2
    video = str(tmp_path / 'clip_ffv1.avi')
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'FFV1'), 30,
                             (64, 48))
    if not writer.isOpened():
        pytest.skip('FFV1 encoder unavailable')
    rng = np.random.default_rng(0)
    for _ in range(12):
        writer.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    reader, jreader = dt.readers(video, batch_size=4, decode_threads=3)
    assert reader._n_stripes == 1
    _same_as_jax(reader, jreader)


def test_striped_short_header_eof(tmp_path):
    """A header frame count above the stream's ends cleanly (EOF, no
    error), with the sequential path's frames."""
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=21)
    reader = dt.reader(video, batch_size=4, decode_threads=3)
    assert reader._n_stripes == 3
    batches = dt.collect(reader)
    # a header that claims more frames than exist: the workers past EOF
    # end cleanly, not with an error
    pair = dt.readers(video, batch_size=4, decode_threads=3)
    for r in pair:
        r.frame_count = 33
        r._n_stripes = 3
    batches2 = _same_as_jax(*pair)
    dt.assert_batches_equal(batches, batches2)
    assert pair[0].frames_read == 21
    assert not pair[0].error_during_read


def test_striped_long_header_tail_read(tmp_path):
    """A header frame count below the stream's: the tail worker reads past
    the claimed count, so the striped output matches the sequential path
    (which reads until cap.read() fails) frame for frame."""
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=23)
    seq = dt.collect(dt.reader(video, batch_size=4))
    pair = dt.readers(video, batch_size=4, decode_threads=3)
    for r in pair:
        r.frame_count = 13  # 10 trailing frames past the header's count
    batches = _same_as_jax(*pair)
    dt.assert_batches_equal(seq, batches)
    assert pair[0].frames_read == 23
    assert not pair[0].error_during_read


def test_striped_truncated_demux_chunk_raises(tmp_path):
    """An undecodable MJPG chunk mid-stream surfaces as VideoReadError from
    the striped fast path, as on the sequential path, in both packages."""
    from ysmr_tpu_torch.io.video import VideoReadError
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=16)
    settings = dt.settings(tmp_path)
    kw = dict(batch_size=4, decode_mode='fast', decode_threads=3)
    reader = dt.reader(video, settings, **kw)
    assert reader._demux is not None and reader._n_stripes == 3
    # frame 6's JPEG entropy data zeroed through the demuxer's own offsets
    start, size = reader._demux.offsets[6]
    with open(video, 'r+b') as f:
        f.seek(start + 2)
        f.write(b'\x00' * min(64, size - 2))
    # new readers, so that the mmap sees the damage
    for r, error in zip(dt.readers(video, settings, **kw),
                        (VideoReadError, JVideoReadError)):
        got = []
        with pytest.raises(error):
            for batch in r:
                got.append(batch['start'])
        assert r.error_during_read
        assert got == [0]  # batch 0 (frames 0-3) came before the error
