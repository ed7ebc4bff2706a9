"""Artifacts of the PyTorch port's stages 3 and 4: evaluate_tracks writes
every artifact, with real plots here (ysmr_tpu_torch/plot_functions.py
imports matplotlib at first use), and its CSVs are ysmr_tpu's bytes;
annotate_video's output decodes to ysmr_tpu's frames, with and without a
phenotype filter."""

import os

import numpy as np
import pytest

from test_outputs import _tracks_df

PLOTS = ['angle_histogram', 'Bac_Run_Overview', 'rose_graph', 'speed',
         'Median_speed', 'perc_motile']


def test_evaluate_writes_all_artifacts(tmp_path, rng, tmp_ini):
    from ysmr_tpu.pipeline.evaluate import evaluate_tracks as jevaluate
    from ysmr_tpu_torch.config import get_configs
    from ysmr_tpu_torch.pipeline.evaluate import evaluate_tracks
    settings = get_configs(tmp_ini)
    settings.update({'verbose': False, 'log to file': False,
                     'minimal length in seconds': 2.0,
                     'limit track length to x seconds': 3.0,
                     'save angle distribution plot / bins': 18})
    df = _tracks_df(rng)
    files = {}
    for name, fn in (('torch', evaluate_tracks), ('jax', jevaluate)):
        folder = tmp_path / name
        folder.mkdir()
        out = fn(path_to_file=str(folder / 'vid_selected_data.csv'),
                 results_directory=str(folder), df=df.copy(),
                 settings=dict(settings), fps=30.0)
        assert out is not None and out[1].shape[0] == 6, name
        files[name] = folder
    for plot in PLOTS:
        path = files['torch'] / 'vid_selected_data_{}.png'.format(plot)
        assert path.is_file() and path.stat().st_size > 1000, plot
    for csv in ('statistics', 'analysed'):
        got, want = ((files[n] / 'vid_selected_data_{}.csv'.format(
            csv)).read_bytes() for n in ('torch', 'jax'))
        assert got == want, csv


def _decoded(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


@pytest.mark.parametrize('subtype', [None, 2, 'motile'])
def test_annotate_video_matches_jax(tmp_path, rng, tmp_ini, subtype):
    import cv2
    import pandas as pd
    from ysmr_tpu.pipeline.annotate import annotate_video as jannotate
    from ysmr_tpu_torch.config import get_configs
    from ysmr_tpu_torch.pipeline.annotate import annotate_video
    settings = get_configs(tmp_ini)
    settings.update({'log to file': False, 'minimal frame count': 5,
                     'save video fourcc codec': 'MJPG',
                     'save video file extension': '.avi'})
    video = str(tmp_path / 'clip.avi')
    wtr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'MJPG'), 30,
                          (160, 120))
    for t in range(12):
        wtr.write(rng.integers(0, 60, (120, 160, 3), dtype=np.uint8))
    wtr.release()
    df = pd.DataFrame({
        'TRACK_ID': [0] * 12 + [1] * 12, 'POSITION_T': list(range(12)) * 2,
        'POSITION_X': np.r_[np.linspace(20, 100, 12),
                            np.linspace(140, 60, 12)],
        'POSITION_Y': np.r_[np.linspace(20, 80, 12), np.full(12, 60.5)],
        'moving': [1] * 12 + [0] * 12,
        'turn_points': [0] * 5 + [1] + [0] * 6 + [0] * 12,
        'motility_phenotype': ['motile'] * 12 + ['immotile'] * 12,
    })
    decoded = {}
    for name, fn in (('torch', annotate_video), ('jax', jannotate)):
        folder = tmp_path / name
        folder.mkdir()
        fn(video, df, output_save=True, settings=dict(settings),
           result_folder=str(folder), select_subtype=subtype)
        (out,) = os.listdir(folder)
        decoded[name] = _decoded(str(folder / out))
    assert len(decoded['torch']) == 12
    for a, b in zip(decoded['torch'], decoded['jax']):
        np.testing.assert_array_equal(a, b)
