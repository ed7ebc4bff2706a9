"""tracking.ini parity: the port's config.get_configs returns the same dict
as the JAX package's for the default ini and for edited ones."""

import configparser

import pytest
import torch

from ysmr_tpu import config as jconfig
from ysmr_tpu_torch import config as tconfig

torch.set_num_threads(1)


def _write(path, edits=(), drop_sections=()):
    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in jconfig.default_config_dict().items():
        if section in drop_sections:
            continue
        parser[section] = {k: str(v) for k, v in values.items()}
    for section, key, value in edits:
        parser[section][key] = value
    with open(path, 'w') as f:
        parser.write(f)
    return path


@pytest.mark.parametrize('edits,drop', [
    ((), ()),
    # the overrides the parity tests and the bench apply
    ((('ADVANCED VIDEO SETTINGS', 'adaptive double threshold', '-1.0'),
      ('GAUSSIAN-SUM FIR FILTER SETTINGS', 'disable gsff', 'True'),
      ('BASIC RECORDING SETTINGS', 'white bacteria on dark background',
       'False'),
      ('BASIC RECORDING SETTINGS', 'threshold offset for detection', '10'),
      ('TPU SETTINGS', 'frame batch size', '64'),
      ('TPU SETTINGS', 'max foreground pixels per frame', '8192'),
      ('TPU SETTINGS', 'run cc', 'on'),
      ('BASIC RECORDING SETTINGS', 'rod shaped bacteria', 'False'),
      ('GAUSSIAN-SUM FIR FILTER SETTINGS', 'maximum horizon size', '0')),
     ()),
    # reference-era ini without the TPU section
    ((), ('TPU SETTINGS',)),
])
def test_get_configs_parity(tmp_path, edits, drop):
    path = _write(str(tmp_path / 'tracking.ini'), edits, drop)
    ours = tconfig.get_configs(path)
    ref = jconfig.get_configs(path)
    assert ours is not None and ours == ref


def test_created_ini_is_identical(tmp_path):
    a, b = str(tmp_path / 'a.ini'), str(tmp_path / 'b.ini')
    tconfig.create_configs(a, open_editor=False)
    jconfig.create_configs(b, open_editor=False)
    assert open(a).read() == open(b).read()
    assert tconfig.get_configs(a) == {
        **jconfig.get_configs(b), 'tracking_ini_filepath': a}


def test_broken_ini_regenerated_both(tmp_path):
    path = str(tmp_path / 'tracking.ini')
    with open(path, 'w') as f:
        f.write('[BASIC RECORDING SETTINGS]\nframes per second = 30\n')
    assert tconfig.get_configs(path) is None
    assert tconfig.get_configs(path) == jconfig.get_configs(path)
