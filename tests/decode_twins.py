"""Shared helpers of the decode twins (``tests/test_torch_exact_decode.py``,
``test_torch_fast_decode.py``, ``test_torch_striped_decode.py``): the
same clip and settings through the port's reader
(``ysmr_tpu_torch.io.video.BatchedVideoReader``) and the JAX package's
(``ysmr_tpu.io.video.BatchedVideoReader``), batch for batch."""

import configparser

import numpy as np

from ysmr_tpu.io.preproc import HostPreprocessor as JHostPreprocessor
from ysmr_tpu.io.video import BatchedVideoReader as JReader
from ysmr_tpu_torch.io.preproc import HostPreprocessor
from ysmr_tpu_torch.io.video import BatchedVideoReader


def settings(tmp_path, extra=None):
    """The default tracking.ini's settings (the port's ``config``), with
    ``extra`` over them."""
    from ysmr_tpu_torch.config import default_config_dict, get_configs
    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in default_config_dict().items():
        parser[section] = {k: str(v) for k, v in values.items()}
    ini = str(tmp_path / 't.ini')
    with open(ini, 'w') as f:
        parser.write(f)
    out = get_configs(ini)
    if extra:
        out.update(extra)
    return out


def reader(video, settings_=None, jax=False, force_cv2=False, max_fg=None,
           **kwargs):
    """The port's reader on ``video`` (with ``jax``, the JAX package's),
    with a host preprocessor of ``settings_`` at 30 fps (none without
    settings); ``force_cv2`` turns its exact fused decode off."""
    pre = None
    if settings_ is not None:
        kw = {} if max_fg is None else dict(max_fg=max_fg)
        pre = (JHostPreprocessor if jax else HostPreprocessor)(
            settings_, 30.0, **kw)
        if force_cv2:
            pre.supports_exact_fused = lambda: False
    return (JReader if jax else BatchedVideoReader)(video, preprocess=pre,
                                                    **kwargs)


def readers(video, settings_=None, **kwargs):
    """(the port's reader, the JAX package's) with the same arguments."""
    return (reader(video, settings_, **kwargs),
            reader(video, settings_, jax=True, **kwargs))


def collect(source):
    """[(start, count, frames)] of every batch of ``source``."""
    return [(b['start'], b['count'], b['frames']) for b in source]


def assert_batches_equal(a, b):
    """Two ``collect`` lists array-equal: start, count and the frames or
    each pixel-table field (the same fields, dtypes and values)."""
    assert len(a) == len(b) > 0
    for (s0, c0, f0), (s1, c1, f1) in zip(a, b):
        assert s0 == s1 and c0 == c1
        if isinstance(f0, dict):
            assert sorted(f0) == sorted(f1)
            for key in f0:
                assert np.asarray(f0[key]).dtype == np.asarray(f1[key]).dtype
                np.testing.assert_array_equal(f0[key], f1[key], err_msg=key)
        else:
            assert f0.dtype == f1.dtype
            np.testing.assert_array_equal(f0, f1)
