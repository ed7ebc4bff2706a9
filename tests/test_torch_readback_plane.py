"""The host-rect batch's readback plane (``ysmr_tpu_torch/ops/run_cc.py::
readback_plane``, which run-CC's finish writes on the card) against the
JAX package's ``detect_from_pixels`` on the run-CC branch, on the CPU.

The plane is (T, Rb + 2) int16: each of the wire's first Rb runs'
detection index (``ysmr_tpu``'s ``det_run_idx``), then the frame's
component count clamped to 32767 (``n_components``) and the propagation's
step count. The JAX package has no step count; the steps column is held
to the port's ``cc_steps`` of the same call and to the iteration cap.
The wires: ``test_torch_detect_pixels.py``'s random blobs with an invalid
last frame, at 64 and 8 detections (more components than detection
slots), with Rb below the longest frame's runs, the host's power of two
and R; every seeded case of ``run_cc_cases.py`` with one frame invalid;
and 40,960 isolated pixels (a count above 32767) at max_det 8.

Tolerance: none. Every value is an integer index or count.
"""

import numpy as np
import pytest
import torch

import run_cc_cases
from test_runs_wire import _random_wire
from test_torch_detect_pixels import _runs
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels as jdetect
from ysmr_tpu_torch.ops import run_cc
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels

torch.set_num_threads(1)

KW = dict(max_bh=16, cc_iters=64, include_luminosity=False,
          use_run_cc=True)


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


def _rb(kind, rcnt, r):
    """The plane's runs: below the longest frame's, the host's choice
    (``stage_detect``: the next power of two, at least 64, at most R), or
    R."""
    return {'short': max(1, int(rcnt.max()) // 2),
            'host': min(r, max(64, _next_pow2(int(rcnt.max())))),
            'all': r}[kind]


def _jax_and_plane(runs, rcnt, fv, h, w, double_threshold, max_det, rb):
    """JAX's det_run_idx and n_components, and the port's plane (the
    wrapper's plain route) and cc_steps, on one wire."""
    ref = jdetect(None, None, rcnt, None, fv, px_runs=runs, run_counts=rcnt,
                  expanded_f=1, h=h, w=w, double_threshold=double_threshold,
                  max_det=max_det, use_pallas=False, return_det_px=True,
                  skip_rect=True, det_px_as_runs=True, **KW)
    launches = run_cc.finish_components.readback_launches
    got = detect_from_pixels(
        None, None, None, None, torch.from_numpy(fv),
        px_runs=torch.from_numpy(runs.view(np.int32)),
        run_counts=torch.from_numpy(rcnt), h=h, w=w,
        double_threshold=double_threshold, max_det=max_det,
        readback_runs=rb, **KW)
    assert run_cc.finish_components.readback_launches == launches
    assert set(got) == {'readback', 'n_components', 'cc_steps'}
    return ref, got


def _check_plane(ref, got, rb, cc_iters=KW['cc_iters']):
    plane = got['readback']
    assert plane.dtype == torch.int16
    assert tuple(plane.shape) == (ref['det_run_idx'].shape[0], rb + 2)
    plane = plane.numpy()
    np.testing.assert_array_equal(plane[:, :rb],
                                  np.asarray(ref['det_run_idx'])[:, :rb])
    n_comp = np.asarray(ref['n_components'])
    np.testing.assert_array_equal(got['n_components'].numpy(), n_comp)
    np.testing.assert_array_equal(plane[:, rb], np.minimum(n_comp, 32767))
    steps = got['cc_steps'].numpy()
    np.testing.assert_array_equal(plane[:, rb + 1], steps)
    assert (steps < cc_iters).all()


@pytest.mark.parametrize('rb_kind', ['short', 'host', 'all'])
@pytest.mark.parametrize('max_det', [64, 8])
@pytest.mark.parametrize('double_threshold', [True, False])
def test_plane_matches_jax_on_random_wires(double_threshold, max_det,
                                           rb_kind):
    rng = np.random.default_rng(5)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    fv = np.ones(t, bool)
    fv[-1] = False
    rb = _rb(rb_kind, rcnt, runs.shape[1])
    ref, got = _jax_and_plane(runs, rcnt, fv, h, w, double_threshold,
                              max_det, rb)
    _check_plane(ref, got, rb)
    plane = got['readback'].numpy()
    assert plane[-1, rb] == 0 and (plane[-1, :rb] == -1).all()
    if max_det == 8:
        assert (np.asarray(ref['n_components'])[:-1] > 8).any()


@pytest.mark.parametrize('case', run_cc_cases.WIRE_CASES)
def test_plane_matches_jax_on_cases(case):
    """The seeded wires the encoder can write, frame 1 invalid, at 64
    detections and at 3 (ids past max_det), Rb the host's and R."""
    runs, rcnt, w = run_cc_cases.run_case(case)
    fv = np.ones(runs.shape[0], bool)
    fv[1] = False
    h = 1 << 10
    for double in (True, False):
        for max_det in (64, 3):
            for kind in ('host', 'all'):
                rb = _rb(kind, rcnt, runs.shape[1])
                ref, got = _jax_and_plane(runs, rcnt, fv, h, w, double,
                                          max_det, rb)
                _check_plane(ref, got, rb)


def test_plane_clamps_a_count_above_int16():
    """40,960 components in a frame (isolated pixels), max_det 8: the count
    column holds 32767 (JAX's n_components is 40,960), every run past the
    first 8 ids is -1, and the invalid second frame counts none."""
    runs, rcnt, w, h = run_cc_cases.many_components()
    fv = np.array([True, False])
    rb = runs.shape[1]
    for double in (True, False):
        ref, got = _jax_and_plane(runs, rcnt, fv, h, w, double, 8, rb)
        _check_plane(ref, got, rb)
        plane = got['readback'].numpy()
        assert int(np.asarray(ref['n_components'])[0]) == \
            run_cc_cases.MANY_COMPONENTS
        assert plane[0, rb] == 32767 and plane[1, rb] == 0
        assert ((plane[0, :rb] >= 0).sum()) == 8


def test_plane_is_the_old_readback_sequence():
    """``readback_plane`` is the sequence ``stage_detect`` ran before the
    finish wrote the plane: ``det_run_idx`` sliced to Rb, the clamped
    count and the steps as two int16 columns, concatenated."""
    rng = np.random.default_rng(7)
    t, r = 5, 300
    n_comp = torch.from_numpy(rng.integers(0, 40000, t).astype(np.int32))
    run_comp = torch.from_numpy(rng.integers(-1, 40000, (t, r)).astype(
        np.int32))
    run_comp = torch.where(run_comp < n_comp[:, None], run_comp,
                           torch.full_like(run_comp, -1))
    steps = torch.from_numpy(rng.integers(0, 64, t).astype(np.int32))
    for max_det, rb in ((512, 300), (8, 64), (40000, 1)):
        comp_rev = torch.where(run_comp >= 0, n_comp[:, None] - 1 - run_comp,
                               torch.full_like(run_comp, -1))
        det_run = torch.where(comp_rev < max_det, comp_rev,
                              torch.full_like(comp_rev, -1)).to(torch.int16)
        want = torch.cat([det_run[:, :rb],
                          n_comp.clamp(max=32767)[:, None].to(torch.int16),
                          steps[:, None].to(torch.int16)], dim=1)
        got = run_cc.readback_plane(run_comp, n_comp, steps, runs=rb,
                                    max_det=max_det)
        assert got.dtype == torch.int16 and torch.equal(got, want)


def test_frame_valid_in_the_prepare_is_rc_eff():
    """``run_cc_components(frame_valid=...)`` (the prepare takes the
    frames' validity) equals the call on JAX's ``rc_eff``, the counts of
    the invalid frames set to 0, in every output; the prepare returns
    those counts."""
    runs, rcnt, w = run_cc_cases.run_case('stale_padding')
    truns = torch.from_numpy(runs.view(np.int32))
    tcnt = torch.from_numpy(rcnt)
    fv = torch.tensor([True, False, True, True])
    rc_eff = torch.where(fv, tcnt, torch.zeros_like(tcnt))
    for double in (True, False):
        for extra in (dict(), dict(row_tables=dict(h=64, max_det=8,
                                                   max_bh=8)),
                      dict(readback=dict(runs=runs.shape[1], max_det=8))):
            kw = dict(w=w, double_threshold=double, **extra)
            got = run_cc.run_cc_components(truns, tcnt, frame_valid=fv, **kw)
            want = run_cc.run_cc_components(truns, rc_eff, **kw)
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    g = run_cc.prepare_runs(truns, tcnt, w=w, dilates=(1,), frame_valid=fv)
    assert torch.equal(g['counts'], rc_eff)
    g = run_cc.prepare_runs(truns, tcnt, w=w, dilates=(1,))
    assert torch.equal(g['counts'], tcnt)


def test_plane_sizes_are_checked():
    """A plane of no runs, of more runs than the wire has, or of no
    detections is refused on the CPU as on the card."""
    runs, rcnt, w = run_cc_cases.run_case('blobs')
    truns = torch.from_numpy(runs.view(np.int32))
    tcnt = torch.from_numpy(rcnt)
    for rb, max_det in ((0, 8), (runs.shape[1] + 1, 8), (16, 0)):
        with pytest.raises(ValueError):
            run_cc.run_cc_components(truns, tcnt, w=w, double_threshold=True,
                                     readback=dict(runs=rb, max_det=max_det))
    with pytest.raises(ValueError):
        detect_from_pixels(
            None, None, torch.from_numpy(rcnt), None,
            torch.ones(runs.shape[0], dtype=torch.bool),
            px_packed=torch.zeros_like(truns), h=64, w=w,
            double_threshold=True, max_det=8, readback_runs=16,
            **dict(KW, use_run_cc=False))
