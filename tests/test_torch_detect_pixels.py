"""Run-CC detection of the PyTorch port (ysmr_tpu_torch/pipeline/
detect_pixels.py) against the JAX package's detect_from_pixels on the same
run wire: det_run_idx, det_valid and n_components must be equal."""

import numpy as np
import pytest
import torch

from test_runs_wire import _random_wire
from ysmr_tpu import native as jnative
from ysmr_tpu.io.preproc import HostPreprocessor as JHostPreprocessor
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels as jdetect
from ysmr_tpu_torch.io.preproc import HostPreprocessor
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels

torch.set_num_threads(1)

KW = dict(max_bh=16, cc_iters=64, include_luminosity=False,
          use_run_cc=True, return_det_px=True, skip_rect=True,
          det_px_as_runs=True)


def _runs(packed, counts, w, r=512):
    t, f = packed.shape
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert jnative.encode_runs_numpy(packed, counts, runs, rcnt, w=w) > 0
    return runs[:, :r], rcnt


def _both(runs, rcnt, fv, h, w, f, double_threshold, max_det):
    ref = jdetect(None, None, rcnt, None, fv, px_runs=runs, run_counts=rcnt,
                  expanded_f=f, h=h, w=w, double_threshold=double_threshold,
                  max_det=max_det, use_pallas=False, **KW)
    got = detect_from_pixels(
        None, None, None, None, torch.from_numpy(fv),
        px_runs=torch.from_numpy(runs.view(np.int32)),
        run_counts=torch.from_numpy(rcnt), expanded_f=f, h=h, w=w,
        double_threshold=double_threshold, max_det=max_det, **KW)
    assert (got['cc_steps'].numpy() < KW['cc_iters']).all()
    for key in ('det_run_idx', 'det_valid', 'n_components'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert got['det_run_idx'].dtype == torch.int16
    return got


@pytest.mark.parametrize('double_threshold', [True, False])
@pytest.mark.parametrize('max_det', [64, 8])
def test_random_wire_matches_jax(double_threshold, max_det):
    """Random blobs, an invalid last frame, and (max_det 8) frames with
    more components than detection slots."""
    rng = np.random.default_rng(5)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    fv = np.ones(t, bool)
    fv[-1] = False
    got = _both(runs, rcnt, fv, h, w, f, double_threshold, max_det)
    assert int(got['n_components'][-1]) == 0


@pytest.mark.parametrize('mode_val', [2.0, 0.0, -1.0])
def test_host_thresholded_frames_match_jax(mode_val):
    """Frames through both packages' host preprocessors (identical wires),
    then both run-CC detections."""
    import cv2
    settings = {
        'white bacteria on dark background': True,
        'threshold offset for detection': 5,
        'adaptive double threshold': mode_val,
        'include luminosity in tracking calculation': False,
        'color filter': cv2.COLOR_BGR2GRAY,
    }
    rng = np.random.default_rng(3)
    h, w, t, f = 96, 128, 4, 4096
    pre = HostPreprocessor(settings, 30.0, max_fg=f)
    jpre = JHostPreprocessor(settings, 30.0, max_fg=f)
    packed = np.zeros((t, f), np.uint32)
    counts = np.zeros(t, np.int32)
    for k in range(t):
        img = rng.normal(40, 4, (h, w)).clip(0, 255).astype(np.uint8)
        for _ in range(10):
            cv2.ellipse(img, (int(rng.integers(8, w - 8)),
                              int(rng.integers(8, h - 8))),
                        (4, 2), int(rng.integers(0, 180)), 0, 360, 200, -1)
        frame = np.repeat(img[..., None], 3, axis=2)
        a, b = pre(frame), jpre(frame)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))
        packed[k] = a['px_packed']
        counts[k] = a['count']
    runs, rcnt = _runs(packed, counts, w, r=1024)
    _both(runs, rcnt, np.ones(t, bool), h, w, f, mode_val > 0, 64)


@pytest.mark.parametrize('kwargs', [
    {'use_run_cc': False}, {'include_luminosity': True},
    {'return_det_px': False}, {'det_px_as_runs': False}])
def test_unported_branches_raise(kwargs):
    args = dict(KW)
    args.update(kwargs)
    runs = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        detect_from_pixels(None, None, None, None,
                           torch.ones(1, dtype=torch.bool), px_runs=runs,
                           run_counts=torch.zeros(1, dtype=torch.int32),
                           expanded_f=8, h=4, w=4, double_threshold=True,
                           max_det=4, **args)


@pytest.mark.cuda
def test_detect_on_cuda_equals_cpu():
    """The CUDA path (kernel + PyTorch ops on the card) gives the CPU
    path's tables. Runs on a machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
    rng = np.random.default_rng(8)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    fv = np.ones(t, bool)
    fv[-1] = False
    for dt in (True, False):
        args = dict(expanded_f=f, h=h, w=w, double_threshold=dt, max_det=64,
                    **KW)
        cpu = detect_from_pixels(
            None, None, None, None, torch.from_numpy(fv),
            px_runs=torch.from_numpy(runs.view(np.int32)),
            run_counts=torch.from_numpy(rcnt), **args)
        before = propagate_min_fused.launches
        gpu = detect_from_pixels(
            None, None, None, None, torch.from_numpy(fv).cuda(),
            px_runs=torch.from_numpy(runs.view(np.int32)).cuda(),
            run_counts=torch.from_numpy(rcnt).cuda(), **args)
        torch.cuda.synchronize()
        assert propagate_min_fused.launches == before + (2 if dt else 1)
        assert (gpu['cc_steps'].cpu().numpy() < KW['cc_iters']).all()
        for key in ('det_run_idx', 'det_valid', 'n_components'):
            np.testing.assert_array_equal(gpu[key].cpu().numpy(),
                                          cpu[key].numpy(), err_msg=key)
