#!/usr/bin/env python3
"""The design variants of the table CC and the run wire's expansion on one
NVIDIA card.

Each variant is ``ysmr_tpu_torch/csrc/table_cc.cu`` or
``ysmr_tpu_torch/csrc/expand_runs.cu`` with one of the alternatives tried
for it put back by a textual edit (threads a block, tile and chunk sizes,
the cross launch's window), built with nvcc into a library of its own
(under ``ysmr_tpu_torch/.build/table_cc_variants/``) and timed with the
unedited source, which runs first and last: the table CC on the bench and
dense batches' pixel tables (64 x 8192 and 64 x 131072, the raster
prefix, double and single threshold), the expansion on their run wires.
Every variant's outputs are first held bit-equal to the plain version.

Run from the root of a checkout on a machine with the card::

    python3 table_cc_variants.py [--variants a,b,...]

It prints one JSON line a variant and input with the device ms of each
launch (``torch.profiler``, the mean over 20 calls) and their sum, and
how many calls' events the profiler dropped; the last line is the card's
name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, 'ysmr_tpu_torch', 'csrc')
OUT = os.path.join(HERE, 'ysmr_tpu_torch', '.build', 'table_cc_variants')


def _const(name, old, new):
    return ('constexpr int {} = {};'.format(name, old),
            'constexpr int {} = {};'.format(name, new))


#: name -> (source, textual edits); 'table' and 'expand' are the sources
#: as they stand
VARIANTS = {
    'table': ('table_cc.cu', []),
    'local256': ('table_cc.cu', [_const('kLocalThreads', 512, 256)]),
    'local1024': ('table_cc.cu', [_const('kLocalThreads', 512, 1024)]),
    'tile1024': ('table_cc.cu', [_const('kTile', 2048, 1024)]),
    'cross64': ('table_cc.cu', [_const('kCrossThreads', 128, 64)]),
    'cross256': ('table_cc.cu', [_const('kCrossThreads', 128, 256)]),
    'window4096': ('table_cc.cu', [_const('kWindow', 2048, 4096)]),
    'flags16': ('table_cc.cu', [_const('kFlagSlots', 4, 16)]),
    'expand': ('expand_runs.cu', []),
    'chunk1024': ('expand_runs.cu', [_const('kChunk', 2048, 1024)]),
    'tile4096': ('expand_runs.cu', [_const('kTile', 2048, 4096)]),
}


def build(names):
    """One nvcc a variant, all started together; name -> ctypes library."""
    sys.path.insert(0, HERE)
    from ysmr_tpu_torch import _build
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        source, edits = VARIANTS[name]
        with open(os.path.join(CSRC, source)) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit('variant {}: edit does not apply: '
                                 '{!r}'.format(name, old))
            src = src.replace(old, new)
        path = os.path.join(OUT, name + '.cu')
        with open(path, 'w') as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc] + _build.NVCC_FLAGS + ['-shared', '-o', path[:-3] + '.so',
                                          path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit('variant {} did not build:\n{}'.format(name, log))
        lib = ctypes.CDLL(os.path.join(OUT, name + '.so'))
        if VARIANTS[name][0] == 'table_cc.cu':
            lib.ysmr_table_cc.restype = ci
            lib.ysmr_table_cc.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        else:
            lib.ysmr_expand_runs.restype = ci
            lib.ysmr_expand_runs.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        libs[name] = lib
    return libs


def launches(fn, reps=20):
    """Mean device ms of each kernel a call over ``reps`` calls of ``fn``:
    its events' mean (the profiler at times drops some) times its launches
    a call, and the calls whose events it dropped (0 when none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, dropped = {}, 0
    for ev in prof.key_averages():
        name = ev.key.replace('void ', '').replace('(anonymous namespace)::',
                                                   '').split('(')[0]
        if ev.count and (name.startswith('tcc_') or
                         name.startswith('expand_')):
            out[name] = round(ev.device_time_total / ev.count / 1000, 4)
            dropped = max(dropped, reps - ev.count)
    return out, dropped if out else reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--variants', default=','.join(VARIANTS))
    args = ap.parse_args()
    names = [n for n in args.variants.split(',') if n]
    if set(names) - set(VARIANTS):
        raise SystemExit('unknown variant in {}'.format(args.variants))
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script runs on a GPU')
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from ysmr_tpu_torch.ops import run_cc
    from ysmr_tpu_torch.ops.cc import cc_labels_table_plain
    # the unedited sources first and last
    order = [n for n in ('table', 'expand') if n in names]
    order = order + [n for n in names if n not in order] + order
    libs = build(names)
    dev = torch.device('cuda', 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    inputs = []
    for label, scene, settings in (
            ('bench', smoke.BenchScene(), smoke.bench_settings()),
            ('dense', smoke.BenchScene(seed=smoke.DENSE_SEED,
                                       n_bugs=smoke.DENSE_BUGS),
             smoke.dense_settings())):
        packed, counts = smoke.packed_batch(scene, settings)
        lists = smoke.lists_from_packed(packed, counts, dev)
        runs, rc = smoke.encode(packed, counts, smoke.W, None)
        inputs.append((label, (lists[1] * smoke.W + lists[0]).contiguous(),
                       lists[2], lists[3],
                       torch.from_numpy(runs.view(np.int32)).to(dev),
                       torch.from_numpy(rc).to(dev), packed.shape[1]))
    for label, lin, valid, marker, wire, rcount, f in inputs:
        t = lin.shape[0]
        for double in (True, False):
            want = cc_labels_table_plain(lin, valid, marker, h=smoke.H,
                                         w=smoke.W, double_threshold=double,
                                         max_iters=smoke.MAX_ITERS)
            conv = want[2] < smoke.MAX_ITERS
            forest = torch.empty((2 if double else 1, t, f),
                                 dtype=torch.int32, device=dev)
            labels = torch.empty((t, f), dtype=torch.int32, device=dev)
            keep = torch.empty((t, f), dtype=torch.bool, device=dev)
            for name in order:
                if VARIANTS[name][0] != 'table_cc.cu':
                    continue

                def call(lib=libs[name]):
                    rc = lib.ysmr_table_cc(
                        lin.data_ptr(), valid.data_ptr(), None,
                        marker.data_ptr(), forest.data_ptr(),
                        labels.data_ptr(), keep.data_ptr(), t, f, smoke.W,
                        int(double), dev.index, stream)
                    if rc != 0:
                        raise SystemExit('{}: launch failed ({})'.format(
                            name, rc))
                call()
                torch.cuda.synchronize()
                if not (torch.equal(labels[conv], want[0][conv]) and
                        torch.equal(keep[conv], want[1][conv])):
                    raise SystemExit('{} {}: != plain'.format(name, label))
                per, dropped = launches(call)
                print(json.dumps({'variant': name, 'input': label,
                                  'double': double,
                                  'ms': round(sum(per.values()), 4),
                                  'launches': per,
                                  'dropped_calls': dropped}), flush=True)
        want = run_cc.expand_runs_plain(wire, rcount, f, True)
        r = wire.shape[1]
        out = (torch.empty((t, f), dtype=torch.int32, device=dev),
               torch.empty((t, f), dtype=torch.bool, device=dev))
        sums = torch.empty((t, max(-(-r // 1024), 1)), dtype=torch.int32,
                           device=dev)
        for name in order:
            if VARIANTS[name][0] != 'expand_runs.cu':
                continue

            def call(lib=libs[name]):
                rc = lib.ysmr_expand_runs(
                    wire.data_ptr(), rcount.data_ptr(), sums.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), t, r, f, 1,
                    dev.index, stream)
                if rc != 0:
                    raise SystemExit('{}: launch failed ({})'.format(name, rc))
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                raise SystemExit('{} {}: != plain'.format(name, label))
            per, dropped = launches(call)
            print(json.dumps({'variant': name, 'input': label + ' wire',
                              'ms': round(sum(per.values()), 4),
                              'launches': per, 'dropped_calls': dropped}),
                  flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
