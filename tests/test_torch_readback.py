"""The compact emissions readback of the PyTorch port ('compact emissions
readback = True'): ``tracker.compact_emissions_device`` bit for bit
against the JAX function on random emissions (live counts under, at and
over the bucket; K = 2 and 3; float payloads with signed zeros,
subnormals and NaNs), and the stage-1 loop with the compact readback
against the padded one on a small dense synthetic clip, with the bucket
started small so that it grows and its overflowing batches fall back to
the padded emissions."""

import os

import numpy as np
import pytest
import torch

from test_e2e_parity import _make_settings, make_synthetic_video
from ysmr_tpu.pipeline.tracker import \
    compact_emissions_device as jcompact
from ysmr_tpu_torch.pipeline import track_bacteria as tb
from ysmr_tpu_torch.pipeline.tracker import compact_emissions_device

torch.set_num_threads(1)


def _random_emissions(rng, t, s, k, live):
    mask = rng.random((t, s)) < live
    mask[0] = False                     # an empty frame
    mask[-1] = True                     # a full frame
    ids = np.where(mask, rng.integers(0, 1 << 20, (t, s)), 0).astype(np.int32)
    det_col = rng.integers(-1, 40, (t, s)).astype(np.int32)
    pos = rng.normal(300, 200, (t, s, k)).astype(np.float32)
    info = rng.normal(0, 50, (t, s, 3)).astype(np.float32)
    # bit patterns a float path could disturb
    special = np.array([-0.0, 1e-45, -3e-39, np.nan, np.inf], np.float32)
    pos.reshape(-1)[:len(special)] = special
    info.reshape(-1)[-len(special):] = special
    return {'mask': mask, 'ids': ids, 'det_col': det_col, 'pos': pos,
            'info': info,
            'n_det': rng.integers(0, 40, t).astype(np.int32)}


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('bucket', [64, 24, 1])
def test_compact_emissions_bit_equal_to_jax(k, bucket):
    rng = np.random.default_rng(17 + k + bucket)
    em = _random_emissions(rng, 6, 64, k, 0.4)
    n_comp = rng.integers(0, 100, 6).astype(np.int32)
    want = np.asarray(jcompact(em, n_comp, bucket=bucket))
    got = compact_emissions_device(
        {key: torch.from_numpy(v) for key, v in em.items()},
        torch.from_numpy(n_comp), bucket=bucket)
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (6, bucket + 1, 5 + k)
    np.testing.assert_array_equal(got.numpy(), want)
    # the smaller buckets drop live slots of some frames
    assert (em['mask'].sum(axis=1) > bucket).any() == (bucket < 64)


def _run_loop(tmp_path, video, compact, name):
    from ysmr_tpu_torch.config import get_configs
    from ysmr_tpu_torch.io.video import BatchedVideoReader
    from ysmr_tpu_torch.io.preproc import HostPreprocessor
    from ysmr_tpu_torch.utils.csv_io import save_list
    settings = get_configs(_make_settings(tmp_path, **{
        'cv2 exact rects': False, 'compact emissions readback': compact}))
    folder = str(tmp_path / name)
    os.makedirs(folder)
    reader = BatchedVideoReader(
        video, batch_size=settings['frame batch size'],
        preprocess=HostPreprocessor(settings, 30.0, max_fg=settings[
            'max foreground pixels per frame']))
    _, list_name = save_list(path=video, result_folder=folder,
                             first_call=True)
    stats = {}
    res = tb._track_loop(reader, settings, 30.0, list_name,
                         device=torch.device('cpu'), stats=stats)
    assert res is not None
    with open(list_name, 'rb') as f:
        return f.read(), stats


def test_compact_readback_equals_padded(tmp_path, monkeypatch):
    """The device-tracker path on a 40-frame clip of 24 rods: the compact
    readback gives the padded readback's ``_list.csv`` bytes. The first
    bucket is 4 slots, so the first batches overflow it: it grows once to
    the next power of two past the largest live count, and those batches
    are read from their padded emissions."""
    monkeypatch.setattr(tb, 'EMISSIONS_BUCKET', 4)
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=40,
                                 seed=5, n_bugs=24)
    padded, pstats = _run_loop(tmp_path, video, False, 'padded')
    compact, cstats = _run_loop(tmp_path, video, True, 'compact')
    assert padded.count(b'\n') > 500
    assert compact == padded
    assert pstats['readback'] == 'padded' and not pstats['bucket_growth']
    assert cstats['readback'] == 'compact'
    growth = cstats['bucket_growth']
    assert len(growth) == 1 and growth[0][:2] == (0, 4)
    assert growth[0][2] in (16, 32)
    # the batch that grew it and the one already in flight read padded
    assert cstats['fallback_batches'] == [0, 8]


@pytest.mark.cuda
@pytest.mark.parametrize('bucket', [64, 24, 1])
def test_compact_emissions_on_cuda_equals_cpu(bucket):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(3)
    em = _random_emissions(rng, 16, 4096, 2, 0.7)
    n_comp = rng.integers(0, 4000, 16).astype(np.int32)
    cpu = compact_emissions_device(
        {key: torch.from_numpy(v) for key, v in em.items()},
        torch.from_numpy(n_comp), bucket=bucket)
    gpu = compact_emissions_device(
        {key: torch.from_numpy(v).cuda() for key, v in em.items()},
        torch.from_numpy(n_comp).cuda(), bucket=bucket)
    assert torch.equal(gpu.cpu(), cpu)
