"""The user's program in the PyTorch port (ysmr_tpu_torch/main.py and
__main__.py): twins of tests/test_main_orchestration.py on the CPU
(``device='cpu'``), the batch-size rules with the display cap, and the
port's ``ysmr()`` against ``ysmr_tpu``'s on one synthetic clip: every CSV
with the same bytes, the ``_meta.json`` sidecars and the xlsx sheets
equal. ``cli(['--device', 'cpu', '--serial', ...])`` drives the same
program from its command line."""

import configparser
import glob
import json
import os
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from test_e2e_parity import make_synthetic_video
from test_main_orchestration import _settings_for

torch.set_num_threads(1)

CSV_SUFFIXES = ('_list.csv', '_selected_data.csv', '_statistics.csv',
                '_analysed.csv')


def _short_tracks(settings):
    settings['minimal length in seconds'] = 1.0
    settings['limit track length to x seconds'] = 1.5
    return settings


def _xlsx_members(folder):
    """The collated workbook's parts (its file name holds the time)."""
    paths = glob.glob(os.path.join(folder, '*_collated_statistics.xlsx'))
    assert len(paths) == 1, paths
    with zipfile.ZipFile(paths[0]) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def test_ysmr_batch_and_csv_restart(tmp_path):
    from ysmr_tpu_torch.main import analyse, ysmr
    v1 = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60, seed=3)
    v2 = make_synthetic_video(str(tmp_path / 'b.avi'), n_frames=60, seed=4)
    settings = _short_tracks(_settings_for(tmp_path, v1))
    result_folder = str(tmp_path / 'results')
    os.makedirs(result_folder)
    finished = ysmr(paths=[v1, v2], settings=settings,
                    result_folder=result_folder, multiprocess=False,
                    device='cpu')
    assert finished is not None and len(finished) == 2
    assert all(res is not None for _, res in finished)
    for stem in ('a', 'b'):
        for suffix in CSV_SUFFIXES:
            path = os.path.join(result_folder, stem + suffix)
            assert os.path.isfile(path), path
        assert os.path.isfile(os.path.join(result_folder, stem + '_meta.json'))
    assert glob.glob(os.path.join(result_folder, '*_collated_statistics.xlsx'))

    # stage restart from the CSV alone (+ _meta.json sidecar)
    first_stats = pd.read_csv(os.path.join(result_folder,
                                           'a_statistics.csv'))
    restart_folder = str(tmp_path / 'restart')
    os.makedirs(restart_folder)
    settings['collate results csv to xlsx'] = False
    out = analyse(os.path.join(result_folder, 'a_list.csv'), settings=settings,
                  result_folder=restart_folder, return_df=True, device='cpu',
                  fps=30.0, frame_height=288, frame_width=384)
    assert out is not None
    restat = pd.read_csv(os.path.join(restart_folder,
                                      'a_list_statistics.csv'))
    assert restat.shape == first_stats.shape
    np.testing.assert_allclose(
        restat['Distance (µm)'].to_numpy(),
        first_stats['Distance (µm)'].to_numpy(), rtol=1e-9, atol=1e-9)
    # 'device' is an argument, not metadata: the sidecar that the restart
    # found and updated holds none
    with open(os.path.join(result_folder, 'a_meta.json')) as f:
        assert sorted(json.load(f)) == ['fps', 'frame_height', 'frame_width']


def test_ysmr_skips_finished_files(tmp_path):
    from ysmr_tpu_torch.main import analyse
    settings = _settings_for(tmp_path, 'unused')
    path = str(tmp_path / 'x_analysed.csv')
    open(path, 'w').write('TRACK_ID\n0\n')
    assert analyse(path, settings=settings, result_folder=str(tmp_path),
                   device='cpu') is None


def test_ysmr_multiprocess_pool(tmp_path):
    """Spawn pool (maxtasksperchild=1) on the device the caller names: the
    good video is processed, the missing path counts as failed without
    aborting the batch (on the card: chip_smoke.py phase 22)."""
    from ysmr_tpu_torch.main import ysmr
    v1 = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60, seed=3)
    v_bad = str(tmp_path / 'missing.avi')
    settings = _short_tracks(_settings_for(tmp_path, v1))
    settings['collate results csv to xlsx'] = False
    result_folder = str(tmp_path / 'results_mp')
    os.makedirs(result_folder)
    finished = ysmr(paths=[v1, v_bad], settings=settings,
                    result_folder=result_folder, multiprocess=True,
                    device='cpu')
    assert finished is not None
    done = {p: r for p, r in finished}
    assert done.get(v_bad) is None and done.get(v1) is not None
    for suffix in CSV_SUFFIXES:
        assert os.path.isfile(os.path.join(result_folder, 'a' + suffix))


def test_resolve_batch_size_rules():
    """On a GPU small batches round up to 64, on the CPU they stay; an
    open live display caps the batch at 16 and shuts the host-rect gate
    (the preview draws the device tables)."""
    from ysmr_tpu_torch.pipeline.track_bacteria import (resolve_batch_size,
                                                        use_host_rects)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    sparse = {'frame batch size': 16, 'max detections per frame': 512}
    dense = {'frame batch size': 16, 'max detections per frame': 4096}
    assert resolve_batch_size(sparse, cuda) == 64
    assert resolve_batch_size(dense, cuda) == 64
    assert resolve_batch_size(sparse, cpu) == 16
    assert resolve_batch_size({'frame batch size': 128}, cuda) == 128
    assert resolve_batch_size(sparse, cuda, True) == 16
    assert resolve_batch_size({'frame batch size': 32}, cuda, True) == 16
    assert resolve_batch_size({'frame batch size': 8}, cuda, True) == 8
    assert resolve_batch_size({'frame batch size': 32}, cpu, True) == 16
    assert use_host_rects(sparse)
    assert not use_host_rects(sparse, True)


def test_ysmr_matches_jax(tmp_path):
    """Both packages' ysmr() on one 60-frame clip at the capacities of
    _settings_for: every CSV with the same bytes, equal sidecars and equal
    workbook parts."""
    from ysmr_tpu.main import ysmr as jysmr
    from ysmr_tpu_torch.main import ysmr
    video = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60,
                                 seed=3)
    folders = {}
    for name, fn, kw in (('jax', jysmr, {}), ('torch', ysmr,
                                             {'device': 'cpu'})):
        settings = _short_tracks(_settings_for(tmp_path, video))
        folders[name] = str(tmp_path / name)
        os.makedirs(folders[name])
        finished = fn(paths=[video], settings=settings,
                      result_folder=folders[name], multiprocess=False, **kw)
        assert finished is not None and finished[0][1] is not None, name
    for suffix in CSV_SUFFIXES:
        got, want = (open(os.path.join(folders[n], 'a' + suffix), 'rb').read()
                     for n in ('torch', 'jax'))
        assert got.count(b'\n') > 5, suffix
        assert got == want, suffix
    got, want = (json.load(open(os.path.join(folders[n], 'a_meta.json')))
                 for n in ('torch', 'jax'))
    assert got == want
    assert _xlsx_members(folders['torch']) == _xlsx_members(folders['jax'])


def _write_ini(path, settings):
    """A tracking.ini whose options take the values of ``settings``."""
    from ysmr_tpu_torch.config import create_configs
    create_configs(path, open_editor=False)
    parser = configparser.ConfigParser(allow_no_value=True)
    parser.read(path)
    for section in parser.sections():
        for key in parser[section]:
            if key in settings:
                parser.set(section, key, str(settings[key]))
    with open(path, 'w') as f:
        parser.write(f)


def test_cli_runs_on_the_cpu(tmp_path):
    from ysmr_tpu_torch.__main__ import cli
    video = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60,
                                 seed=3)
    ini = str(tmp_path / 'cli.ini')
    settings = _short_tracks(_settings_for(tmp_path, video))
    _write_ini(ini, {k: settings[k] for k in (
        'user input', 'select files', 'display video analysis', 'save video',
        'log to file', 'minimal frame count', 'minimal length in seconds',
        'limit track length to x seconds', 'frame batch size',
        'max detections per frame', 'max track slots')})
    folder = str(tmp_path / 'out')
    assert cli(['--device', 'cpu', '--serial', '--settings', ini,
                '--result-folder', folder, video]) == 0
    for suffix in CSV_SUFFIXES:
        assert os.path.isfile(os.path.join(folder, 'a' + suffix)), suffix


def test_unported_and_unavailable(tmp_path):
    """'shard videos across devices' with several paths is ported: missing
    files count as failed, nothing raises (the sharded run itself:
    tests/test_torch_multi_video.py); 'cuda' raises on a host without a
    GPU."""
    from ysmr_tpu_torch.main import ysmr
    settings = _settings_for(tmp_path, 'unused')
    settings['shard videos across devices'] = True
    paths = [str(tmp_path / 'a.avi'), str(tmp_path / 'b.avi')]
    finished = ysmr(paths=paths, settings=settings,
                    result_folder=str(tmp_path / 'r'), device='cpu')
    assert finished == [(p, None) for p in paths]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            ysmr(paths=[str(tmp_path / 'a.avi')],
                 settings=_settings_for(tmp_path, 'unused'))


@pytest.mark.cuda
def test_ysmr_on_cuda_equals_cpu(tmp_path, monkeypatch):
    """ysmr() on the card (the default device) writes the CPU run's CSVs.
    The plots are stubbed (the GPU machine may lack matplotlib; stage 3
    always draws a violin); chip_smoke.py holds the spawn pool on the card
    with the stub in its workers."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import sys
    import types
    from ysmr_tpu_torch.main import ysmr
    stub = types.ModuleType('ysmr_tpu_torch.plot_functions')
    for name in ('angle_distribution_plot', 'large_xy_plot', 'rose_graph',
                 'violin_plot'):
        setattr(stub, name, lambda *args, **kwargs: None)
    monkeypatch.setitem(sys.modules, 'ysmr_tpu_torch.plot_functions', stub)
    video = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60,
                                 seed=3)
    out = {}
    for name, kw in (('cpu', {'device': 'cpu'}), ('cuda', {})):
        settings = _short_tracks(_settings_for(tmp_path, video))
        settings['collate results csv to xlsx'] = False
        folder = str(tmp_path / name)
        os.makedirs(folder)
        finished = ysmr(paths=[video], settings=settings, result_folder=folder,
                        **kw)
        assert finished[0][1] is not None, name
        out[name] = [open(os.path.join(folder, 'a' + s), 'rb').read()
                     for s in CSV_SUFFIXES]
    assert out['cuda'] == out['cpu']
