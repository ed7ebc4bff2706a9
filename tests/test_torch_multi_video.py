"""The port's sharded multi-video stage 1
(ysmr_tpu_torch/parallel/multi_video.py) on the CPU: twin of
tests/test_multi_video.py.

Three synthetic clips of uneven length (48, 40, 36 frames at 192x144) and
one clip of another geometry (a second group) on a 2-entry CPU mesh:

- each ``_list.csv`` is byte-identical to the port's solo frames-mode
  ``track_bacteria`` with the same settings;
- TRACK_ID and POSITION_T equal ``ysmr_tpu``'s ``track_videos_sharded``
  (on two of its virtual CPU devices), the other columns within 2e-4, the
  frames-mode GSFF residue of
  tests/test_torch_track_bacteria.py::test_frames_mode_rows_match_jax;
- mean-threshold mode runs each video solo; a missing file gives None;
- a mesh spread over several processes is refused;
- ``ysmr()`` with ``shard videos across devices`` writes every stage's
  artifacts for every clip, and with ``multiprocess=True`` spawns no pool.
"""

import glob
import os

import numpy as np
import pytest
import torch

from test_e2e_parity import _make_settings, make_synthetic_video
from ysmr_tpu.parallel import sharding as jshd
from ysmr_tpu.parallel.multi_video import \
    track_videos_sharded as jtrack_videos_sharded
from ysmr_tpu_torch import track_bacteria
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded

torch.set_num_threads(1)


def _small_clip_settings(tmp_path, **overrides):
    """tests/test_multi_video.py's settings (copied: that file imports
    ``tests.test_e2e_parity``, which some hosts cannot resolve)."""
    settings = _make_settings(tmp_path)
    settings.update({
        'minimal length in seconds': 1.0,
        'limit track length to x seconds': 1.5,
        'frame batch size': 8,
        'max detections per frame': 32,
        'max track slots': 64,
        'transfer mode': 'frames',
    })
    settings.update(overrides)
    return settings


def _clips(tmp_path, lengths=(48, 40, 36), w=192, h=144):
    """tests/test_multi_video.py's clips: seeds 20, 21, ..."""
    return [make_synthetic_video(str(tmp_path / 'clip{}.avi'.format(i)),
                                 n_frames=n, w=w, h=h, seed=20 + i, n_bugs=6)
            for i, n in enumerate(lengths)]


def _videos(tmp_path):
    """The three clips of test_multi_video.py and one 160x128 clip."""
    return _clips(tmp_path) + [make_synthetic_video(
        str(tmp_path / 'other.avi'), n_frames=40, w=160, h=128, seed=30,
        n_bugs=6)]


def _folder(tmp_path, name):
    folder = str(tmp_path / name)
    os.makedirs(folder)
    return folder


@pytest.mark.e2e
def test_sharded_matches_solo_and_jax(tmp_path):
    videos = _videos(tmp_path)
    settings = _small_clip_settings(tmp_path)
    sharded = track_videos_sharded(
        videos, settings=dict(settings),
        result_folder=_folder(tmp_path, 'shard'),
        mesh=shd.make_mesh(2, device='cpu'), device='cpu')
    ref = jtrack_videos_sharded(videos, settings=dict(settings),
                                result_folder=_folder(tmp_path, 'jax'),
                                mesh=jshd.make_mesh(2))
    solo_dir = _folder(tmp_path, 'solo')
    for video in videos:
        solo = track_bacteria(video, settings=dict(settings),
                              result_folder=solo_dir, device='cpu')
        got = sharded[video]
        assert solo is not None and got is not None, video
        assert got[1:4] == solo[1:4] == ref[video][1:4]
        with open(got[4], 'rb') as f, open(solo[4], 'rb') as g:
            got_bytes = f.read()
            assert got_bytes == g.read(), video
        assert got_bytes.count(b'\n') > 100
        df, jdf = got[0], ref[video][0]
        assert df.shape == jdf.shape
        for col in ('TRACK_ID', 'POSITION_T'):
            np.testing.assert_array_equal(df[col].to_numpy(),
                                          jdf[col].to_numpy(), err_msg=col)
        for col in ('POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                    'DEGREES_ANGLE'):
            np.testing.assert_allclose(df[col].to_numpy(),
                                       jdf[col].to_numpy(), rtol=0,
                                       atol=2e-4, err_msg=col)


@pytest.mark.e2e
def test_mean_threshold_runs_solo_and_missing_file(tmp_path):
    """Mean-threshold mode: each video through the port's track_bacteria
    (the same bytes as a solo run); a missing file gives None and leaves
    the others alone."""
    videos = _clips(tmp_path, lengths=(36,))
    missing = str(tmp_path / 'missing.avi')
    mean = _small_clip_settings(tmp_path, **{'adaptive double threshold':
                                             -1.0})
    got = track_videos_sharded(videos + [missing], settings=dict(mean),
                               result_folder=_folder(tmp_path, 'mean'),
                               device='cpu')
    solo = track_bacteria(videos[0], settings=dict(mean),
                          result_folder=_folder(tmp_path, 'mean_solo'),
                          device='cpu')
    assert got[missing] is None
    with open(got[videos[0]][4], 'rb') as f, open(solo[4], 'rb') as g:
        assert f.read() == g.read()
    out = track_videos_sharded(videos + [missing],
                               settings=_small_clip_settings(tmp_path),
                               result_folder=_folder(tmp_path, 'adaptive'),
                               mesh=shd.make_mesh(2, device='cpu'),
                               device='cpu')
    assert out[missing] is None and out[videos[0]] is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            track_videos_sharded(videos, settings=dict(mean))


def test_mesh_of_several_processes_is_refused(tmp_path):
    """Stage 1 is one process: a mesh whose shards are spread over a
    process group (here rank 1 of 2, built by hand) raises before any
    video is read or any file written."""
    clip = _clips(tmp_path, lengths=(4,))[0]
    folder = _folder(tmp_path, 'out')
    mesh = shd.Mesh([torch.device('cpu')] * 4, ('videos',), rank=1, world=2)
    assert mesh.local_shards == [2, 3]
    with pytest.raises(ValueError, match='one process'):
        track_videos_sharded([clip], settings=_small_clip_settings(tmp_path),
                             result_folder=folder, mesh=mesh, device='cpu')
    assert os.listdir(folder) == []


@pytest.mark.e2e
def test_ysmr_sharded_dispatch(tmp_path, monkeypatch):
    """ysmr() with 'shard videos across devices': the whole artifact chain
    for every clip from one sharded stage-1 pass; the pool is replaced."""
    from ysmr_tpu_torch import main
    videos = _clips(tmp_path, lengths=(44, 38))

    def no_pool(*args, **kwargs):
        raise AssertionError('the process pool was spawned')

    monkeypatch.setattr(main, '_dispatch_pool', no_pool)
    staged = []
    real = main.track_videos_sharded
    monkeypatch.setattr(main, 'track_videos_sharded',
                        lambda paths, *a, **k: staged.append(list(paths))
                        or real(paths, *a, **k))
    settings = _small_clip_settings(
        tmp_path, **{'shard videos across devices': True,
                     'collate results csv to xlsx': True})
    result_folder = _folder(tmp_path, 'results')
    finished = main.ysmr(paths=videos, settings=settings,
                         result_folder=result_folder, multiprocess=True,
                         device='cpu')
    assert staged == [videos]
    assert finished is not None and len(finished) == 2
    assert all(res is not None for _, res in finished)
    for stem in ('clip0', 'clip1'):
        for suffix in ('_list.csv', '_selected_data.csv', '_statistics.csv',
                       '_analysed.csv', '_meta.json'):
            path = os.path.join(result_folder, stem + suffix)
            assert os.path.isfile(path), path
    assert glob.glob(os.path.join(result_folder,
                                  '*_collated_statistics.xlsx'))
