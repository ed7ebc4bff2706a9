"""Detection of the PyTorch port (ysmr_tpu_torch/pipeline/detect_pixels.py)
against the JAX package's detect_from_pixels on the same wires, bit for
bit: the run-CC branch (det_run_idx, det_valid and n_components) and the
pixel-table branch on each of its three wires (the run wire expanded, the
packed pixel wire, the split wire of luminosity), with host rects
(det_px_idx) and with device rects, with and without luminosity. The JAX
side runs its CPU path (two whole-frame labelings); the port's plain
cc_labels_at_pixels converges on every frame here."""

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


def _wires(seed=5, h=120, w=160, t=6, f=2048):
    rng = np.random.default_rng(seed)
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    lin = (packed & 0x7FFFFFFF).astype(np.int64)
    split = ((lin % w).astype(np.int16), (lin // w).astype(np.int16),
             (packed >> 31).astype(np.uint8))
    fv = np.ones(t, bool)
    fv[-1] = False
    gray = rng.integers(0, 256, (t, h, w), dtype=np.uint8)
    return packed, counts, runs, rcnt, split, fv, gray


def _wire_args(wire, packed, counts, runs, rcnt, split, fv, f):
    """(jax args, jax kwargs, torch args, torch kwargs) of one wire."""
    if wire == 'runs':
        jargs, jkw = (None, None, counts, None, fv), dict(
            px_runs=runs, run_counts=rcnt, expanded_f=f)
        tkw = dict(px_runs=torch.from_numpy(runs.view(np.int32)),
                   run_counts=torch.from_numpy(rcnt), expanded_f=f)
    elif wire == 'packed':
        jargs, jkw = (None, None, counts, None, fv), dict(px_packed=packed)
        tkw = dict(px_packed=torch.from_numpy(packed.view(np.int32)))
    else:
        jargs, jkw, tkw = split[:2] + (counts, split[2], fv), {}, {}
    targs = tuple(None if a is None else torch.from_numpy(a) for a in jargs)
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize('skip_rect', [True, False])
@pytest.mark.parametrize('wire', ['runs', 'packed', 'split'])
def test_pixel_table_branch_matches_jax(wire, skip_rect):
    """Every output of the pixel-table branch, single and double
    threshold; with device rects also with the exact rect luminosity of
    the gray frames and the pixel-mean luminosity of per-pixel gray."""
    packed, counts, runs, rcnt, split, fv, gray = _wires()
    h, w, f = 120, 160, 2048
    jargs, jkw, targs, tkw = _wire_args(wire, packed, counts, runs, rcnt,
                                        split, fv, f)
    px_gray = np.random.default_rng(6).integers(0, 256, packed.shape)
    for dt, lum in ((True, None), (False, None), (True, 'frames'),
                    (True, 'pixels')):
        kw = dict(h=h, w=w, double_threshold=dt, max_det=24, max_bh=16,
                  cc_iters=64, return_det_px=skip_rect, skip_rect=skip_rect,
                  cv2_centers=not skip_rect,
                  include_luminosity=lum is not None)
        jextra, textra = {}, {}
        if lum == 'frames':
            jextra['gray_frames'] = gray
            textra['gray_frames'] = torch.from_numpy(gray)
        elif lum == 'pixels':
            jextra['px_gray'] = px_gray.astype(np.int32)
            textra['px_gray'] = torch.from_numpy(px_gray)
        ref = jdetect(*jargs, use_pallas=False, **jkw, **jextra, **kw)
        got = detect_from_pixels(*targs, **tkw, **textra, **kw)
        assert set(got) == set(ref) | {'cc_steps'}
        for key in ref:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]),
                                          err_msg='{} {} {}'.format(
                                              key, dt, lum))
        assert got['det_xy'].shape[-1] == (3 if lum else 2)
        assert int(got['det_valid'].sum()) > 20
        if lum:
            assert (got['det_xy'][..., 2][got['det_valid']] > 0).all()


@pytest.mark.parametrize('double_threshold,max_det,skip_rect,narrow', [
    (True, 64, True, False), (False, 64, True, False),
    (True, 8, True, False), (True, 64, True, True),
    (True, 64, False, False)])
def test_det_px_from_runs_matches_jax(double_threshold, max_det, skip_rect,
                                      narrow):
    """The run-CC branch with ``det_px_as_runs=False``: the per-pixel
    detection index expanded on the device (``run_cc.det_px_from_runs``)
    equals JAX's, with host rects and beside the device rects, on random
    wires (an invalid last frame; with max_det 8 components past the
    slots; ``narrow``: a table narrower than some frames' pixels)."""
    rng = np.random.default_rng(9)
    h, w, t = 120, 160, 6
    packed, counts = _random_wire(rng, t, 2048, h, w)
    runs, rcnt = _runs(packed, counts, w)
    fv = np.ones(t, bool)
    fv[-1] = False
    for f in ((int(np.median(counts)),) if narrow else (2048,)):
        kw = dict(KW, det_px_as_runs=False, skip_rect=skip_rect,
                  cv2_centers=not skip_rect, expanded_f=f, h=h, w=w,
                  double_threshold=double_threshold, max_det=max_det)
        ref = jdetect(None, None, rcnt, None, fv, px_runs=runs,
                      run_counts=rcnt, use_pallas=False, **kw)
        got = detect_from_pixels(
            None, None, None, None, torch.from_numpy(fv),
            px_runs=torch.from_numpy(runs.view(np.int32)),
            run_counts=torch.from_numpy(rcnt), **kw)
        assert set(got) == set(ref) | {'cc_steps'}
        assert got['det_px_idx'].dtype == torch.int16
        assert got['det_px_idx'].shape == (t, f)
        for key in ref:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        det = got['det_px_idx'].numpy()
        assert (det[:-1] >= 0).sum() > 100 and (det[-1] == -1).all()


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


@pytest.mark.cuda
def test_pixel_table_on_cuda_equals_cpu():
    """The pixel-table branch on the card (the cc_labels_at_pixels kernel,
    one launch per call) gives the CPU path's tables on each wire, with
    host rects and with device rects and luminosity. Runs on a machine
    with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    from ysmr_tpu_torch.ops.cc import cc_labels_at_pixels
    packed, counts, runs, rcnt, split, fv, gray = _wires()
    for wire in ('runs', 'packed', 'split'):
        _, _, targs, tkw = _wire_args(wire, packed, counts, runs, rcnt,
                                      split, fv, 2048)
        for skip in (True, False):
            kw = dict(h=120, w=160, double_threshold=True, max_det=24,
                      max_bh=16, cc_iters=64, return_det_px=skip,
                      skip_rect=skip, include_luminosity=not skip,
                      gray_frames=None if skip else torch.from_numpy(gray),
                      **tkw)
            cpu = detect_from_pixels(*targs, **kw)
            before = cc_labels_at_pixels.launches
            gpu = detect_from_pixels(
                *(None if a is None else a.cuda() for a in targs),
                **{k: v.cuda() if torch.is_tensor(v) else v
                   for k, v in kw.items()})
            torch.cuda.synchronize()
            assert cc_labels_at_pixels.launches == before + 1
            for key in cpu:
                np.testing.assert_array_equal(gpu[key].cpu().numpy(),
                                              cpu[key].numpy(),
                                              err_msg=(wire, skip, key))


@pytest.mark.cuda
def test_det_px_from_runs_on_cuda_equals_cpu():
    """``det_px_from_runs`` on the card (the run-CC kernel, then its
    scatter and cumulative max) gives the CPU path's per-pixel index."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.default_rng(9)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    fv = np.ones(t, bool)
    fv[-1] = False
    kw = dict(KW, det_px_as_runs=False, expanded_f=f, h=h, w=w,
              double_threshold=True, max_det=8)
    cpu = detect_from_pixels(
        None, None, None, None, torch.from_numpy(fv),
        px_runs=torch.from_numpy(runs.view(np.int32)),
        run_counts=torch.from_numpy(rcnt), **kw)
    gpu = detect_from_pixels(
        None, None, None, None, torch.from_numpy(fv).cuda(),
        px_runs=torch.from_numpy(runs.view(np.int32)).cuda(),
        run_counts=torch.from_numpy(rcnt).cuda(), **kw)
    for key in ('det_px_idx', 'det_valid', 'n_components'):
        np.testing.assert_array_equal(gpu[key].cpu().numpy(),
                                      cpu[key].numpy(), err_msg=key)
