"""Stages 2 and 3 of the PyTorch port (ysmr_tpu_torch/pipeline/select.py and
evaluate.py, copies of the JAX package's host modules) against ysmr_tpu's
on the adversarial random track tables of
tests/test_select_eval_parity.py: the returned frames equal and every CSV
written with the same bytes, 'limit track length exactly' included."""

import os

import numpy as np
import pandas as pd
import pytest

from test_select_eval_parity import F_H, F_W, FPS, _random_track_table
from test_select_eval_parity import _settings as _parity_settings


def _settings(tmp_path, **more):
    settings = _parity_settings(tmp_path)
    settings.update(more)
    return settings


def _both(tmp_path, stage, df, settings, **kw):
    """Run a stage of each package on copies of ``df`` into its own
    folder; returns {name: (output, {file name: bytes})}."""
    from ysmr_tpu.pipeline import evaluate as jeval, select as jsel
    from ysmr_tpu_torch.pipeline import evaluate as teval, select as tsel
    fns = {'select': (jsel.select_tracks, tsel.select_tracks),
           'evaluate': (jeval.evaluate_tracks, teval.evaluate_tracks)}[stage]
    out = {}
    for name, fn in zip(('jax', 'torch'), fns):
        folder = tmp_path / (stage + '_' + name)
        folder.mkdir()
        res = fn(path_to_file='rand.csv', df=df.copy(),
                 results_directory=str(folder), settings=dict(settings),
                 **kw)
        assert res is not None, name
        files = {f: open(os.path.join(folder, f), 'rb').read()
                 for f in sorted(os.listdir(folder)) if f.endswith('.csv')}
        out[name] = (res, files)
    return out


def _same_files(out):
    (_, jfiles), (_, tfiles) = out['jax'], out['torch']
    assert jfiles and sorted(tfiles) == sorted(jfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


@pytest.mark.parametrize('seed', [11, 29])
def test_select_matches_jax(tmp_path, seed):
    df = _random_track_table(np.random.default_rng(seed))
    out = _both(tmp_path, 'select', df, _settings(tmp_path), fps=FPS,
                frame_height=F_H, frame_width=F_W)
    pd.testing.assert_frame_equal(out['torch'][0], out['jax'][0])
    assert 0 < len(out['torch'][0]) < len(df)
    _same_files(out)


def test_evaluate_matches_jax(tmp_path):
    from ysmr_tpu.pipeline.select import select_tracks
    settings = _settings(tmp_path)
    df = _random_track_table(np.random.default_rng(5))
    sel = select_tracks(path_to_file='rand.csv', df=df.copy(),
                        results_directory=str(tmp_path), fps=FPS,
                        frame_height=F_H, frame_width=F_W,
                        settings=dict(settings))
    assert sel is not None and len(sel)
    out = _both(tmp_path, 'evaluate', sel, settings, fps=FPS)
    for got, want in zip(out['torch'][0], out['jax'][0]):
        pd.testing.assert_frame_equal(got, want)
    _same_files(out)


def test_select_length_limit_matches_jax(tmp_path):
    """'limit track length exactly': a track that reaches start + limit - 1
    is cut there, one with a hole at that frame is dropped (the rows of
    tests/test_select_eval_parity.py::test_select_exact_length_limit_
    semantics, and a random table)."""
    settings = _settings(tmp_path, **{
        'limit track length exactly': True,
        'minimal length in seconds': 1.0,
        'limit track length to x seconds': 2.0})
    rows = [(tid, t, 100.0 + tid * 50 + 0.3 * t, 100.0, 6.0, 3.0, 45.0)
            for tid, hole in ((0, False), (1, True)) for t in range(100)
            if not (hole and t == 59)]
    df = pd.DataFrame(rows, columns=['TRACK_ID', 'POSITION_T', 'POSITION_X',
                                     'POSITION_Y', 'WIDTH', 'HEIGHT',
                                     'DEGREES_ANGLE'])
    out = _both(tmp_path, 'select', df, settings, fps=FPS,
                frame_height=F_H, frame_width=F_W)
    got = out['torch'][0]
    pd.testing.assert_frame_equal(got, out['jax'][0])
    assert sorted(got['TRACK_ID'].unique()) == [0]
    assert got['POSITION_T'].max() == 59 and len(got) == 60
    _same_files(out)
    rand = _random_track_table(np.random.default_rng(29))
    sub = tmp_path / 'random'
    sub.mkdir()
    out = _both(sub, 'select', rand, settings, fps=FPS, frame_height=F_H,
                frame_width=F_W)
    pd.testing.assert_frame_equal(out['torch'][0], out['jax'][0])
    _same_files(out)
