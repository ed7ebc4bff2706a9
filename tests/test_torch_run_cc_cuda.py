"""Run-graph CC on the card: the launches of ``csrc/run_cc.cu``
(``ysmr_tpu_torch/ops/run_cc.py``'s ``prepare_runs``,
``compact_kept_runs`` and ``finish_components`` on CUDA tensors) against
their plain versions on the same card tensors, bit for bit, on the seeded
wires of the root module ``run_cc_cases.py`` that
``tests/test_torch_run_cc.py`` holds to the plain versions on the CPU (the
finish with and without the row tables of the device rects, on converged,
one-step and random labels); and ``run_cc_components``,
``keep_marked_runs`` and ``label_runs`` through them against the CPU
route. This file imports no JAX.

Tolerance: none. Every output is an integer index, count or flag.
"""

import numpy as np
import pytest
import torch

from run_cc_cases import CASES, WIRE_CASES, run_case
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
    s = run_cc.prepare_runs_plain(runs, counts, w=w, dilates=(1,))
    gen = torch.Generator(device=dev).manual_seed(5)
    inputs = []
    for init, win, link, c_orig, n_kept, st4 in (
            (c['init'], c['win'], c['link'], c['c_orig'], c['n_kept'],
             steps4),
            (s['init'], s['wins'][0], s['link'], None, None, None)):
        for iters in (64, 1):
            lab, steps = run_cc.propagate_min(init, win, link,
                                              max_iters=iters)
            inputs.append((lab, c_orig, n_kept, st4, steps))
        lab = torch.randint(-2, runs.shape[1] + 2, runs.shape, device=dev,
                            generator=gen, dtype=torch.int32)
        inputs.append((lab, c_orig, n_kept, st4, steps))
    for args in inputs:
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


@pytest.mark.cuda
def test_run_cc_kernels_refuse_bad_inputs_on_cuda():
    """A frame wider than the start field, R above the compact and finish
    launches' cap, mismatched planes, the sorted runs (the plain
    version's only) and empty row tables raise before any launch."""
    dev = _cuda()
    runs, counts, w = _wire('blobs', dev)
    with pytest.raises(ValueError):
        run_cc.prepare_runs(runs, counts, w=(1 << 26) + 1, dilates=(1,))
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
    for kw in (dict(sorted_runs=True),
               dict(row_tables=dict(h=64, max_det=0, max_bh=8))):
        with pytest.raises(ValueError):
            run_cc.finish_components(runs, counts, lab, None, None, None,
                                     steps, w=w, **kw)
    with pytest.raises(ValueError):
        run_cc.run_cc_components(runs, counts, w=w, double_threshold=True,
                                 sorted_runs=True)
    assert run_cc.finish_components.launches == n
