#!/usr/bin/env python3
"""Frames-mode times of the port on one NVIDIA card: the split of a warm
64-frame detect into its steps, and the detect, stage-1 and multi-video
times of one or more checkouts in turns.

Run from the root of a checkout::

    python3 frames_mode_times.py [--roots DIR,DIR,...] [--split]
        [--split-root DIR] [--mode adaptive|mean] [--lum]

``--roots`` lists checkouts in the order to run them (default: this one),
e.g. ``.scratch/parent,.,.,.scratch/parent`` after unpacking the other
tree with ``git archive <commit> | tar -x -C .scratch/parent``. Each runs
in a process of its own that imports that checkout's ``ysmr_tpu_torch``
and ``chip_smoke.py`` and prints one JSON line:

- ``detect_ms``: median host-clock ms (card synchronised; 10 calls after
  2 warm-ups) of ``detect.detect_batch`` on the bench scene's first 64
  frames (1228x922, BGR on the card; the bench capacities in frames mode:
  adaptive double threshold, 512 detections, max_bh 64), with the
  detect's device operations and device ms (``detect_ops``,
  ``detect_device_ms``: ``torch.profiler``, median of three) and its host
  synchronisations (``detect_syncs``: the warnings of
  ``torch.cuda.set_sync_debug_mode``), ``mean_ms``
  of ``preprocess.adaptive_gaussian_mean`` on its blurred frames and,
  where the checkout has it, ``masks_ms`` of the fused preprocess
  ``preprocess.adaptive_masks_from_bgr`` on its BGR frames, each also as
  the median of CUDA-event spans (``mean_event_ms``, ``masks_event_ms``,
  ``masks_gray_event_ms`` with the gray);
- ``bench_fps`` and ``device_detect_ms``: the bench scene (630 frames) in
  memory through the stage-1 loop in frames mode on ``cuda``, as smoke
  phase 10 runs it (frames/s and the ``device_detect`` stage, ms a frame);
- ``mv_wall_s``: smoke phase 23's ``track_videos_sharded`` call (four
  full-width clips of 192, 160, 128 and 96 frames and one 640x480 clip of
  64, frames mode, batch 16) after one solo run of the small clip, twice.

``--split`` (this checkout, or the one ``--split-root`` names; ``--roots
''`` then measures none) records ``torch.profiler`` (CPU and CUDA)
over the steps of the same warm detect run one at a time, each ended by a
synchronise, and gives each step the device operations and device time
of the kernels that start inside its window and inside no window nested
in it (median of three passes), with the three longest kernels of each
step; the steps' outputs are held to ``detect_batch``'s. The steps are
``detect_batch``'s: the fused preprocess ("adaptive masks": gray, blur,
adaptive mean, both rules and ``& frame_valid`` in one launch),
reconstruction, labeling, "compaction + row tables"
(``compact_row_tables``), "stats tail" (``_stats_tail_from_tables``'
own operations: count and the candidate points in a checkout that builds
them, none where the hull writes count), with "hull"
(``hull_edge_vectors``) and "edge finish" (the rest of
``_hull_edge_data``) nested in it, and "rect + output"
(``detections_from_tables``) with "sweep" (``sweep_extents``) nested. A
checkout from before the compaction kernel or the fused preprocess
splits its own detect with its own copy of this script (its steps in
place of these): ``cd <checkout> && python3 frames_mode_times.py
--split --roots .``.

``--mode mean`` takes the same bench capacities with ``adaptive double
threshold = -1.0`` (mean-threshold mode, a fresh 5 s window for each
detect): the detect's numbers as above, the mean-mode entries'
CUDA-event spans where the checkout has them
(``prepare_event_ms``, ``prepare_gray_event_ms``, ``masks_event_ms``),
``bench_fps`` and ``device_detect_ms`` in mean mode, and no multi-video
call (mean mode runs each video solo). Its ``--split`` steps are "mean
prepare" (``mean_prepare_from_bgr``), "host thresholds" (the copy of the
sums and ``frame_valid`` and the moving average), "mean masks"
(``mean_masks``), then labeling, compaction + row tables, stats tail and
rect + output as above; a checkout from before the mean-mode kernels
splits into "gray", "blur", "sums", "host thresholds" (its four copies)
and "threshold" (``global_threshold`` and ``& frame_valid``) in their
place, with this script.

``--lum`` adds ``include luminosity in tracking calculation`` (smoke
phase 16's frames mode): the detect's numbers as above with the gray
frames and the exact rect mean, a ``rect_mean`` record of the rect mean
called alone on the arguments the detect gave it (its slots, device
operations and ms, CUDA-event ms and host synchronisations),
``bench_fps`` and ``device_detect_ms`` with luminosity, and no
multi-video call; its ``--split`` takes the gray from the fused
preprocess and nests "rect mean" (``rect_mean_luminosity``) in "rect +
output".
The last line is the card's name and power limit from ``nvidia-smi``.
"""

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import cv2
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


#: the settings of ``--mode mean`` besides the bench capacities
MEAN = {'adaptive double threshold': -1.0}


def _setup(root, mode='adaptive', lum=False):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from ysmr_tpu_torch.pipeline import detect
    os.makedirs(cs.WORK, exist_ok=True)
    settings = {**cs.bench_settings(), **cs.FRAMES,
                **(MEAN if mode == 'mean' else {}),
                **(cs.LUM if lum else {})}
    scene = cs.BenchScene()
    bgr = np.stack([cv2.cvtColor(scene.frame(t), cv2.COLOR_GRAY2BGR)
                    for t in range(64)])
    dev = torch.device('cuda', 0)
    bgr = torch.from_numpy(bgr).to(dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    return cs, detect, settings, scene, bgr, valid


def _host_ms(fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _fresh_state(cfg, pp):
    """A new 5 s moving-average window (mean mode), else None."""
    if cfg.mode != 'mean':
        return None
    return pp.MovingAverageThreshold(30, cfg.offset, cfg.white_on_dark)


def _device_profile(fn):
    """(device operations, device ms) of one call of ``fn`` under
    ``torch.profiler``, the median of three profiles after a warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ops, ms = [], []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        ops.append(len(dev))
        ms.append(sum(e.time_range.elapsed_us() for e in dev) / 1e3)
    return int(np.median(ops)), float(np.median(ms))


def _syncs(fn):
    """The host synchronisations of one call of ``fn``: the warnings
    ``torch.cuda.set_sync_debug_mode('warn')`` raises in it."""
    import warnings
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def _rect_mean_alone(run_detect):
    """The rect mean called alone on the arguments ``run_detect`` gave
    it: its slots, device operations and ms, CUDA-event ms and host
    synchronisations."""
    from ysmr_tpu_torch.ops import luminosity as lum
    real = lum.rect_mean_luminosity
    seen = []

    @functools.wraps(real)
    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)
    lum.rect_mean_luminosity = spy
    try:
        run_detect()
    finally:
        lum.rect_mean_luminosity = real
    args, kwargs = seen[0]

    def call():
        return lum.rect_mean_luminosity(*args, **kwargs)
    ops, ms = _device_profile(call)
    import chip_smoke as cs
    return {'slots': list(args[1].shape), 'valid': int(args[6].sum()),
            'gray': str(args[0].dtype), 'device_ops': ops, 'device_ms': ms,
            'event_ms': cs.cuda_ms(call, reps=20), 'syncs': _syncs(call)}


def measure(root, mode='adaptive', lum=False):
    """The JSON record of one checkout (see the module docstring)."""
    cs, detect, settings, scene, bgr, valid = _setup(root, mode, lum)
    from ysmr_tpu_torch.ops import preprocess as pp
    from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded
    from ysmr_tpu_torch.pipeline.track_bacteria import track_bacteria
    cfg = detect.DetectorConfig(settings)
    rec = {'root': root, 'mode': mode, 'lum': lum}

    def run_detect():
        return detect.detect_batch(bgr, valid, cfg,
                                   threshold_state=_fresh_state(cfg, pp))

    rec['detect_ms'] = _host_ms(run_detect)
    rec['detect_ops'], rec['detect_device_ms'] = _device_profile(run_detect)
    rec['detect_syncs'] = _syncs(run_detect)
    if lum:
        rec['rect_mean'] = _rect_mean_alone(run_detect)
        frames = [scene.frame(t) for t in range(cs.N_FRAMES)]
        _, _, stats = cs.run_loop(frames, settings, 'cuda', 'times_lum')
        rec['bench_fps'] = stats['fps']
        rec['device_detect_ms'] = stats['stage_s']['device_detect'] / \
            stats['frames'] * 1e3
        return rec
    if mode == 'mean':
        if hasattr(pp, 'mean_prepare_from_bgr'):
            blurred, sums, _ = pp.mean_prepare_from_bgr(bgr)
            thr = torch.full((64,), 60, dtype=torch.int32, device=bgr.device)
            rec['prepare_event_ms'] = cs.cuda_ms(
                lambda: pp.mean_prepare_from_bgr(bgr), reps=30)
            rec['prepare_gray_event_ms'] = cs.cuda_ms(
                lambda: pp.mean_prepare_from_bgr(bgr, True), reps=30)
            rec['masks_event_ms'] = cs.cuda_ms(
                lambda: pp.mean_masks(blurred, thr, valid, True), reps=30)
        frames = [scene.frame(t) for t in range(cs.N_FRAMES)]
        _, _, stats = cs.run_loop(frames, settings, 'cuda', 'times_mean')
        rec['bench_fps'] = stats['fps']
        rec['device_detect_ms'] = stats['stage_s']['device_detect'] / \
            stats['frames'] * 1e3
        return rec
    blurred = detect.prepare_batch(bgr)[1]
    rec['mean_ms'] = _host_ms(lambda: pp.adaptive_gaussian_mean(blurred))
    rec['mean_event_ms'] = cs.cuda_ms(
        lambda: pp.adaptive_gaussian_mean(blurred), reps=30)
    if hasattr(pp, 'adaptive_masks_from_bgr'):
        def masks(gray=False):
            return pp.adaptive_masks_from_bgr(
                bgr, valid, cfg.mode, cfg.offset, cfg.double_delta,
                cfg.white_on_dark, gray)
        rec['masks_ms'] = _host_ms(masks)
        rec['masks_event_ms'] = cs.cuda_ms(masks, reps=30)
        rec['masks_gray_event_ms'] = cs.cuda_ms(lambda: masks(True), reps=30)
    frames = [scene.frame(t) for t in range(cs.N_FRAMES)]
    _, _, stats = cs.run_loop(frames, settings, 'cuda', 'times_frames')
    rec['bench_fps'] = stats['fps']
    rec['device_detect_ms'] = stats['stage_s']['device_detect'] / \
        stats['frames'] * 1e3
    sets = {**cs.bench_settings(), **cs.MV_SETTINGS}
    with tempfile.TemporaryDirectory(dir=cs.WORK) as td:
        paths = [cs.make_clip(os.path.join(td, 'mv_{}.avi'.format(seed)), n,
                              cs.BenchScene(seed=seed))
                 for seed, n in cs.MV_CLIPS]
        seed, n_other, size = cs.MV_OTHER
        paths.append(cs.make_clip(os.path.join(td, 'mv_other.avi'), n_other,
                                  cs.BenchScene(seed=seed), size=size))
        os.makedirs(os.path.join(td, 'solo'))
        track_bacteria(paths[-1], settings=dict(sets),
                       result_folder=os.path.join(td, 'solo'))
        rec['mv_wall_s'] = []
        for i in range(2):
            folder = os.path.join(td, 'sharded{}'.format(i))
            os.makedirs(folder)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = track_videos_sharded(paths, settings=dict(sets),
                                       result_folder=folder, device='cuda')
            torch.cuda.synchronize()
            rec['mv_wall_s'].append(time.perf_counter() - t0)
            if any(v is None for v in out.values()):
                raise SystemExit('multi-video: a clip gave no result')
    return rec


def _mean_steps(cfg, pp, bgr, valid, st):
    """Mean mode's steps up to the mask (see the module docstring): the
    kernels' where the checkout has them, else the torch passes."""
    n, h, w = bgr.shape[:3]

    def thresholds(total, hi, lo, valid_np):
        state = _fresh_state(cfg, pp)
        mean, std = pp.combine_mean_std(h * w, total, hi, lo)
        thr = np.zeros(n, np.int32)
        for i in range(n):
            if valid_np[i]:
                thr[i] = state.update(mean[i], std[i])
        st['thr'] = torch.from_numpy(thr).to(bgr.device)

    if hasattr(pp, 'mean_prepare_from_bgr'):
        def prepare():
            st['blurred'], st['sums'], _ = pp.mean_prepare_from_bgr(bgr)

        def host():
            sv = torch.cat((st['sums'], valid[:, None].to(torch.int32)),
                           dim=1).cpu().numpy()
            thresholds(sv[:, 0], sv[:, 1], sv[:, 2], sv[:, 3])

        return (('mean prepare', prepare), ('host thresholds', host),
                ('mean masks', lambda: st.update(rec=pp.mean_masks(
                    st['blurred'], st['thr'], valid, cfg.white_on_dark))))

    def host():
        thresholds(*(x.cpu().numpy() for x in st['sums']),
                   valid.cpu().numpy())

    return (
        ('gray', lambda: st.update(gray=pp.bgr_to_gray(bgr))),
        ('blur', lambda: st.update(blurred=pp.blur3(st['gray']))),
        ('sums', lambda: st.update(sums=pp.frame_mean_std_sums(st['gray']))),
        ('host thresholds', host),
        ('threshold', lambda: st.update(rec=pp.global_threshold(
            st['blurred'], st['thr'], cfg.white_on_dark) &
            valid[:, None, None])))


def split(root, mode='adaptive', lum=False):
    """The per-step device operations and times of a warm 64-frame detect
    (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cs, detect, settings, _, bgr, valid = _setup(root, mode, lum)
    from ysmr_tpu_torch.ops import cc, hull, sweep
    from ysmr_tpu_torch.ops import luminosity as lum_ops
    from ysmr_tpu_torch.ops import labeling as lb
    from ysmr_tpu_torch.ops import preprocess as pp
    from ysmr_tpu_torch.pipeline.detect_pixels import detections_from_tables
    cfg = detect.DetectorConfig(settings)
    if cfg.mode not in ('adaptive_double', 'mean'):
        raise SystemExit('the split follows the adaptive double threshold '
                         'or mean mode')
    if lum and cfg.mode == 'mean':
        raise SystemExit('the split takes luminosity in the adaptive modes')
    st = {}

    def masks():
        st['mask'], st['markers'], st['gray'] = pp.adaptive_masks_from_bgr(
            bgr, valid, cfg.mode, cfg.offset, cfg.double_delta,
            cfg.white_on_dark, **({'want_gray': True} if lum else {}))

    # a checkout whose labeling hands the compaction its packed mask
    packs = 'return_bits' in inspect.signature(
        cc.label_components_whole_frame).parameters
    # a checkout whose stats tail still forms abs_y from max_bh
    tail_kw = {'max_bh': cfg.max_bh} if 'max_bh' in inspect.signature(
        lb._stats_tail_from_tables).parameters else {}

    def labeling():
        out = cc.label_components_whole_frame(
            st['rec'], connectivity=8, max_iters=cfg.cc_iters,
            **({'return_bits': True} if packs else {}))
        st['labels'], st['bits'] = out if packs else (out, None)

    def compact():
        *st['rows'], st['n'] = lb.compact_row_tables(
            st['labels'], st['rec'], max_det=cfg.max_det, max_bh=cfg.max_bh,
            **({'fg_bits': st['bits']} if packs else {}))

    if cfg.mode == 'mean':
        # the mask takes the reconstruction's place (st['rec'])
        front = _mean_steps(cfg, pp, bgr, valid, st)
    else:
        front = (('adaptive masks', masks),
                 ('reconstruction', lambda: st.update(
                     rec=cc.binary_reconstruct(st['mask'], st['markers'],
                                               max_iters=cfg.cc_iters))))
    steps = front + (
        ('labeling', labeling),
        ('compaction + row tables', compact),
        ('stats tail', lambda: st.update(tables=lb._stats_tail_from_tables(
            *st['rows'], **tail_kw))),
        ('rect + output', lambda: st.update(out=detections_from_tables(
            st['tables'], 64, max_det=cfg.max_det, max_bh=cfg.max_bh,
            n_components=st['n'], **({'gray_frames': st['gray'],
                                      'lum_win': cfg.lum_win} if lum
                                     else {})))),
    )
    nested = ((hull, 'hull_edge_vectors', 'hull'),
              (lb, '_hull_edge_data', 'edge finish'),
              (sweep, 'sweep_extents', 'sweep'),
              (lum_ops, 'rect_mean_luminosity', 'rect mean'))

    def in_window(fn, name):
        """``fn`` inside the step's window; its attributes (a kernel
        wrapper's ``launches``) carried over."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            with record_function('step: ' + name):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return wrapped

    def run_steps():
        for name, fn in steps:
            in_window(fn, name)()

    saved = [(mod, f, getattr(mod, f)) for mod, f, _ in nested]
    for (mod, f, fn), (_, _, name) in zip(saved, nested):
        setattr(mod, f, in_window(fn, name))
    try:
        for _ in range(2):
            run_steps()
        want = detect.detect_batch(bgr, valid, cfg,
                                   threshold_state=_fresh_state(cfg, pp))
        for key in want:
            if not torch.equal(want[key], st['out'][key]):
                raise SystemExit('the split steps differ from detect_batch '
                                 'in {}'.format(key))
        passes = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_steps()
            passes.append(_per_window(prof))
    finally:
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    out = {}
    names = [n for n, _ in steps] + [n for _, _, n in nested]
    for name in names:
        recs = [p.get(name, {'device_ops': 0, 'device_ms': 0.0,
                             'span_ms': 0.0, 'kernels': {}})
                for p in passes]
        out[name] = {key: float(np.median([r[key] for r in recs]))
                     for key in ('device_ops', 'device_ms', 'span_ms')}
        out[name]['device_ops'] = int(out[name]['device_ops'])
        out[name]['top_kernels'] = {
            k[:60]: round(v, 4) for k, v in sorted(
                recs[-1]['kernels'].items(), key=lambda kv: -kv[1])[:3]}
    return out


def _per_window(prof):
    """Each window's device operations, device ms (the operations that
    start inside it and inside no window nested in it), span ms and
    kernels, of one profiled pass."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    windows = [(e.name[len('step: '):], e.time_range) for e in
               prof.events() if e.device_type == cpu and
               e.name.startswith('step: ')]
    per = {name: {'device_ops': 0, 'device_ms': 0.0,
                  'span_ms': rng.elapsed_us() / 1e3, 'kernels': {}}
           for name, rng in windows}
    for e in prof.events():
        if e.device_type != gpu or e.name.startswith('step: '):
            continue
        inside = [(rng.end - rng.start, name) for name, rng in windows
                  if rng.start <= e.time_range.start < rng.end]
        if not inside:
            continue
        rec = per[min(inside)[1]]
        ms = e.time_range.elapsed_us() / 1e3
        rec['device_ops'] += 1
        rec['device_ms'] += ms
        rec['kernels'][e.name] = rec['kernels'].get(e.name, 0.0) + ms
    return per


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--roots', default=HERE,
                    help='comma-separated checkouts, run in this order')
    ap.add_argument('--split', action='store_true',
                    help='the per-step split of a warm detect')
    ap.add_argument('--split-root', default=HERE,
                    help='the checkout whose detect --split splits')
    ap.add_argument('--mode', choices=('adaptive', 'mean'),
                    default='adaptive', help='the threshold mode: the '
                    'adaptive double threshold or mean-threshold mode')
    ap.add_argument('--lum', action='store_true',
                    help='with luminosity (the gray frames and the exact '
                    'rect mean)')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script measures the card')
    if args.one:
        print(json.dumps(measure(args.one, args.mode, args.lum)), flush=True)
        return
    if args.split:
        root = os.path.abspath(args.split_root)
        print(json.dumps({'root': root, 'mode': args.mode, 'lum': args.lum,
                          'split': split(root, args.mode, args.lum)}),
              flush=True)
    for root in filter(None, args.roots.split(',')):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', root, '--mode', args.mode] +
                              (['--lum'] if args.lum else []), cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit('{} failed:\n{}'.format(root, proc.stderr[-4000:]))
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == '__main__':
    main()
