"""Run-graph CC on the card: the launches of ``csrc/run_cc.cu``
(``ysmr_tpu_torch/ops/run_cc.py``'s ``prepare_runs``,
``compact_kept_runs`` and ``finish_components`` on CUDA tensors) against
their plain versions on the same card tensors, bit for bit, on the seeded
wires of the root module ``run_cc_cases.py`` that
``tests/test_torch_run_cc.py`` holds to the plain versions on the CPU (the
finish with and without the row tables of the device rects or the
host-rect batch's readback plane, on converged, one-step and random
labels; the prepare with and without ``frame_valid``); and
``run_cc_components``,
``keep_marked_runs`` and ``label_runs`` through them against the CPU
route. This file imports no JAX.

Tolerance: none. Every output is an integer index, count or flag.
"""

import numpy as np
import pytest
import torch

from run_cc_cases import CASES, WIRE_CASES, run_case
from run_cc_cases import many_components as run_case_many
from ysmr_tpu_torch.ops import run_cc
from ysmr_tpu_torch.ops.run_prop import propagate_min_fused

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _wire(case, dev):
    runs, counts, w = run_case(case)
    return (torch.from_numpy(runs.view(np.int32)).to(dev),
            torch.from_numpy(counts).to(dev), w)


def _same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], '{}.{}'.format(what, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, '{}[{}]'.format(what, i))
    elif want is None:
        assert got is None, what
    else:
        assert got.dtype == want.dtype and got.shape == want.shape and \
            torch.equal(got, want), what


#: the row tables of the checks: a frame height past every case's rows,
#: and capacities with 8 rows, 1 row and ids past max_det
TABLES = (None, dict(h=1024, max_det=64, max_bh=8),
          dict(h=1024, max_det=64, max_bh=1), dict(h=1024, max_det=3,
                                                    max_bh=8))


def _finish_inputs(runs, counts, w, c, steps4):
    """The finish's inputs after the compaction ``c`` and on the wire's
    table: the propagation's labels, those after one step and random
    labels."""
    s = run_cc.prepare_runs_plain(runs, counts, w=w, dilates=(1,))
    gen = torch.Generator(device=runs.device).manual_seed(5)
    inputs = []
    for init, win, link, c_orig, n_kept, st4 in (
            (c['init'], c['win'], c['link'], c['c_orig'], c['n_kept'],
             steps4),
            (s['init'], s['wins'][0], s['link'], None, None, None)):
        for iters in (64, 1):
            lab, steps = run_cc.propagate_min(init, win, link,
                                              max_iters=iters)
            inputs.append((lab, c_orig, n_kept, st4, steps))
        lab = torch.randint(-2, runs.shape[1] + 2, runs.shape,
                            device=runs.device, generator=gen,
                            dtype=torch.int32)
        inputs.append((lab, c_orig, n_kept, st4, steps))
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_run_cc_kernels_match_plain_on_cuda(case):
    """Each call against its plain version on the same card tensors:
    prepare for one and two dilations, both inits; compact on the
    4-connected labels; finish with and without the compaction and the
    row tables, on the propagation's labels, after one step and random.
    One call of each wrapper a check, the inputs untouched."""
    dev = _cuda()
    runs, counts, w = _wire(case, dev)
    before = runs.clone(), counts.clone()
    for dilates, weak in (((0, 1), True), ((1,), False), ((0,), True),
                          ((0,), False)):
        n = run_cc.prepare_runs.launches
        got = run_cc.prepare_runs(runs, counts, w=w, dilates=dilates,
                                  weak_init=weak)
        assert run_cc.prepare_runs.launches == n + 1
        want = run_cc.prepare_runs_plain(runs, counts, w=w, dilates=dilates,
                                         weak_init=weak)
        _same(got, want, 'prepare {} {}'.format(dilates, weak))
    g = run_cc.prepare_runs_plain(runs, counts, w=w, dilates=(0, 1),
                                  weak_init=True)
    lab4, steps4 = propagate_min_fused(g['init'], g['wins'][0], g['link'])
    n = run_cc.compact_kept_runs.launches
    c = run_cc.compact_kept_runs(runs, counts, lab4, g['wins'][1], w=w)
    assert run_cc.compact_kept_runs.launches == n + 1
    _same(c, run_cc.compact_kept_runs_plain(runs, counts, lab4,
                                            g['wins'][1], w=w), 'compact')
    for args in _finish_inputs(runs, counts, w, c, steps4):
        for tables in TABLES:
            n = run_cc.finish_components.launches
            got = run_cc.finish_components(runs, counts, *args, w=w,
                                           row_tables=tables)
            assert run_cc.finish_components.launches == n + 1
            want = run_cc.finish_components_plain(
                runs, counts, *args, w=w, row_tables=tables)
            _same(got, want, 'finish {}'.format(tables))
    torch.cuda.synchronize()
    assert torch.equal(runs, before[0]) and torch.equal(counts, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize('case', WIRE_CASES)
def test_run_cc_components_on_cuda_equal_plain_and_cpu(case):
    """``run_cc_components`` through the kernels equals its plain version
    on the card and the CPU route; ``keep_marked_runs`` and
    ``label_runs`` equal the CPU route. The wires the encoder can write:
    on runs of length 0 below a count the windows are not those of a
    raster-ordered table, outside ``csrc/run_prop.cu``'s contract, where
    its fixpoint need not be the plain propagation's."""
    dev = _cuda()
    runs, counts, w = _wire(case, dev)
    cpu = (runs.cpu(), counts.cpu())
    for double in (True, False):
        for tables in TABLES:
            kw = dict(w=w, double_threshold=double, row_tables=tables)
            got = run_cc.run_cc_components(runs, counts, **kw)
            _same(got, run_cc.run_cc_components_plain(runs, counts, **kw),
                  'plain')
            want = run_cc.run_cc_components(*cpu, **kw)
            for k in want:
                if k != 'cc_steps':   # the kernel reports 0 steps
                    _same(got[k].cpu(), want[k], k)
    keep = run_cc.keep_marked_runs(runs, counts, w=w)
    assert torch.equal(keep.cpu(), run_cc.keep_marked_runs(*cpu, w=w))
    for conn in (4, 8):
        lab, _ = run_cc.label_runs(runs, counts, w=w, connectivity=conn)
        want, _ = run_cc.label_runs(*cpu, w=w, connectivity=conn)
        assert torch.equal(lab.cpu(), want)


def _readbacks(r):
    """The readback planes of the checks: every run at 64 detections, the
    first half at 3 (ids past max_det), one run."""
    return (dict(runs=r, max_det=64), dict(runs=max(1, r // 2), max_det=3),
            dict(runs=1, max_det=64))


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_readback_plane_and_frame_valid_match_plain_on_cuda(case):
    """The finish's readback plane (the host-rect batch's int16 plane) and
    the prepare's ``frame_valid`` (the counts of the invalid frames set to
    0 by the keys launch) against the plain versions on the same card
    tensors, bit for bit: the prepare with frame 1 invalid and with every
    frame valid; the finish after the compaction and on the wire's table,
    on converged, one-step and random labels, with each plane alone and
    with the row tables beside it; one counted launch, with the plane,
    each; and ``run_cc_components`` with both against its plain version
    and, on the wires the encoder can write, the CPU route."""
    dev = _cuda()
    runs, counts, w = _wire(case, dev)
    t, r = runs.shape
    fv = torch.ones(t, dtype=torch.bool, device=dev)
    fv[1] = False
    for valid in (fv, torch.ones_like(fv)):
        for dilates, weak in (((0, 1), True), ((1,), False)):
            got = run_cc.prepare_runs(runs, counts, w=w, dilates=dilates,
                                      weak_init=weak, frame_valid=valid)
            _same(got, run_cc.prepare_runs_plain(
                runs, counts, w=w, dilates=dilates, weak_init=weak,
                frame_valid=valid), 'prepare {}'.format(dilates))
    g = run_cc.prepare_runs_plain(runs, counts, w=w, dilates=(0, 1),
                                  weak_init=True, frame_valid=fv)
    eff = g['counts']
    lab4, steps4 = propagate_min_fused(g['init'], g['wins'][0], g['link'])
    c = run_cc.compact_kept_runs_plain(runs, eff, lab4, g['wins'][1], w=w)
    for args in _finish_inputs(runs, eff, w, c, steps4):
        for plane in _readbacks(r):
            for tables in (None, dict(h=1024, max_det=plane['max_det'],
                                      max_bh=8)):
                n = run_cc.finish_components.launches
                n_rb = run_cc.finish_components.readback_launches
                got = run_cc.finish_components(runs, eff, *args, w=w,
                                               row_tables=tables,
                                               readback=plane)
                assert run_cc.finish_components.launches == n + 1
                assert run_cc.finish_components.readback_launches == \
                    n_rb + 1
                _same(got, run_cc.finish_components_plain(
                    runs, eff, *args, w=w, row_tables=tables,
                    readback=plane), 'finish {} {}'.format(plane, tables))
    cpu = (runs.cpu(), counts.cpu())
    for double in (True, False):
        for plane in _readbacks(r):
            kw = dict(w=w, double_threshold=double, readback=plane)
            got = run_cc.run_cc_components(runs, counts, frame_valid=fv,
                                           **kw)
            _same(got, run_cc.run_cc_components_plain(
                runs, counts, frame_valid=fv, **kw), 'plain')
            if case in WIRE_CASES:
                want = run_cc.run_cc_components(*cpu, frame_valid=fv.cpu(),
                                                **kw)
                # the kernel reports 0 steps, where the plane holds them
                for k in ('run_comp', 'n_components', 'n_px'):
                    _same(got[k].cpu(), want[k], k)
                _same(got['readback'][:, :-1].cpu(),
                      want['readback'][:, :-1], 'readback')


@pytest.mark.cuda
def test_readback_plane_count_above_int16_on_cuda():
    """40,960 components in a frame (``run_cc_cases.many_components``),
    the second frame invalid, max_det 8: the plane through the kernels
    equals its plain version on the card and the CPU route, its count
    column 32767."""
    dev = _cuda()
    runs_np, counts_np, w, _ = run_case_many()
    runs = torch.from_numpy(runs_np.view(np.int32)).to(dev)
    counts = torch.from_numpy(counts_np).to(dev)
    fv = torch.tensor([True, False], device=dev)
    r = runs.shape[1]
    for double in (True, False):
        kw = dict(w=w, double_threshold=double, frame_valid=fv,
                  readback=dict(runs=r, max_det=8))
        got = run_cc.run_cc_components(runs, counts, **kw)
        _same(got, run_cc.run_cc_components_plain(runs, counts, **kw),
              'plain')
        want = run_cc.run_cc_components(
            runs.cpu(), counts.cpu(), **dict(kw, frame_valid=fv.cpu()))
        _same(got['readback'].cpu(), want['readback'], 'cpu')
        assert int(got['readback'][0, r]) == 32767
        assert int(got['readback'][1, r]) == 0


#: the kernels of a host-rect detect on the card: run-CC's and the
#: propagation's, nothing else
RUN_CC_KERNELS = ('keys_kernel', 'prepare_kernel', 'keep_kernel',
                  'compact_kernel', 'roots_kernel', 'ids_kernel',
                  'run_prop_init', 'run_prop_unite', 'run_prop_out')


@pytest.mark.cuda
@pytest.mark.parametrize('case', WIRE_CASES)
def test_host_rect_detect_is_run_cc_kernels_on_cuda(case):
    """``detect_from_pixels(readback_runs=...)``, the host-rect batch's
    detect, on the card equals the CPU route (the steps column aside: the
    kernel reports 0) with frame 1 invalid, and makes no device operation
    but the launches of ``csrc/run_cc.cu`` and ``csrc/run_prop.cu``: 12
    with the double threshold (7 without), one finish with the plane."""
    from torch.profiler import ProfilerActivity, profile

    from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
    dev = _cuda()
    runs, counts, w = _wire(case, dev)
    fv = torch.ones(runs.shape[0], dtype=torch.bool, device=dev)
    fv[1] = False
    for double in (True, False):
        kw = dict(h=1024, w=w, double_threshold=double, max_det=8,
                  max_bh=16, cc_iters=64, use_run_cc=True,
                  readback_runs=runs.shape[1])

        def call(dev_args):
            return detect_from_pixels(None, None, None, None, dev_args[2],
                                      px_runs=dev_args[0],
                                      run_counts=dev_args[1], **kw)
        want = call((runs.cpu(), counts.cpu(), fv.cpu()))
        call((runs, counts, fv))
        torch.cuda.synchronize()
        n_rb = run_cc.finish_components.readback_launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = call((runs, counts, fv))
            torch.cuda.synchronize()
        assert run_cc.finish_components.readback_launches == n_rb + 1
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == (12 if double else 7), names
        assert all(any(k in n for k in RUN_CC_KERNELS) for n in names), \
            names
        _same(got['readback'][:, :-1].cpu(), want['readback'][:, :-1],
              'readback')
        _same(got['n_components'].cpu(), want['n_components'], 'count')


@pytest.mark.cuda
def test_run_cc_kernels_refuse_bad_inputs_on_cuda():
    """A frame wider than the start field, R above the compact and finish
    launches' cap, mismatched planes, the sorted runs (the plain
    version's only) and empty row tables raise before any launch."""
    dev = _cuda()
    runs, counts, w = _wire('blobs', dev)
    with pytest.raises(ValueError):
        run_cc.prepare_runs(runs, counts, w=(1 << 26) + 1, dilates=(1,))
    with pytest.raises(ValueError):
        run_cc.prepare_runs(runs, counts, w=w, dilates=(1,),
                            frame_valid=torch.ones(runs.shape[0] + 1,
                                                   dtype=torch.bool,
                                                   device=dev))
    big = torch.zeros((1, run_cc.RUN_CC_MAX_RUNS + 1), dtype=torch.int32,
                      device=dev)
    one = torch.zeros((1,), dtype=torch.int32, device=dev)
    g = run_cc.prepare_runs(big, one, w=w, dilates=(1,))
    with pytest.raises(ValueError):
        run_cc.compact_kept_runs(big, one, g['init'], g['wins'][0], w=w)
    g = run_cc.prepare_runs(runs, counts, w=w, dilates=(1,))
    with pytest.raises(ValueError):
        run_cc.compact_kept_runs(runs, counts, g['init'].long(),
                                 g['wins'][0], w=w)
    with pytest.raises(ValueError):
        run_cc.finish_components(big, one, big, None, None, None, one, w=w)
    lab, steps = propagate_min_fused(g['init'], g['wins'][0], g['link'])
    n = run_cc.finish_components.launches
    r = runs.shape[1]
    for kw in (dict(sorted_runs=True),
               dict(row_tables=dict(h=64, max_det=0, max_bh=8)),
               dict(readback=dict(runs=0, max_det=8)),
               dict(readback=dict(runs=r + 1, max_det=8)),
               dict(readback=dict(runs=r, max_det=0)),
               dict(readback=dict(runs=r, max_det=8),
                    row_tables=dict(h=64, max_det=16, max_bh=8))):
        with pytest.raises(ValueError):
            run_cc.finish_components(runs, counts, lab, None, None, None,
                                     steps, w=w, **kw)
    with pytest.raises(ValueError):
        run_cc.run_cc_components(runs, counts, w=w, double_threshold=True,
                                 sorted_runs=True)
    assert run_cc.finish_components.launches == n
