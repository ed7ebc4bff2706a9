"""track_bacteria(): video -> _list.csv, stage 1 of the PyTorch port.

Counterpart of ``ysmr_tpu/pipeline/track_bacteria.py::track_bacteria`` in
its default configuration, the one whose rows are identical to YSMR's:

1. host decode and host threshold (native library, in the reader's
   threads): per frame a packed uint32 pixel wire;
2. the run-length wire (native ``encode_runs_batch``);
3. on the device, run-graph connected components (``ops/run_cc.py``, with
   the CUDA kernel ``csrc/run_prop.cu``): one detection index per run;
4. that index, the component count and the propagation step count come
   back in one pinned int16 buffer (``non_blocking`` copy plus a CUDA
   event), one batch in flight: the host measures batch i - 1 while the
   device labels batch i;
5. cv2-exact rects (``native/cv2_exact.cpp``) and the float64 tracker
   (``native/tracker64.cpp``) on the host;
6. ``_list.csv``, appended every ``list save length interval`` rows and
   rewritten sorted at the end.

Same contract as the JAX entry point: writes ``_list.csv`` and returns
``(df, fps, frame_height, frame_width, csv_path)``, or None on the errors
the reference reports that way. The device defaults to ``cuda`` and the
call raises without one; CPU runs happen only when a caller passes
``device='cpu'``. Settings outside the ported slice raise
``NotImplementedError`` naming the ROADMAP item that ports them; a missing
native library raises (there is no slower fallback path to take).
"""

import logging
import os
import time

import numpy as np
import torch

from ysmr_tpu_torch import native as native_mod
from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.io.preproc import HostPreprocessor
from ysmr_tpu_torch.io.video import BatchedVideoReader, VideoReadError
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.ops.gsff import GSFFParams
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
from ysmr_tpu_torch.utils.csv_io import (finalize_sorted_list, save_list,
                                         sort_list)
from ysmr_tpu_torch.utils.files import create_results_folder
from ysmr_tpu_torch.utils.logging_utils import get_loggers


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


def resolve_device(device):
    """torch.device for ``device``; raises when CUDA is asked for and
    missing (the port never carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("No CUDA device available; pass device='cpu' "
                               'to run the plain PyTorch path on the CPU.')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError('Unsupported device: {}'.format(device))
    return dev


def _require_native():
    if not native_mod.available():
        raise RuntimeError('ysmr_tpu_torch needs the native host library '
                           '(native/libysmr_native.so or its build).')


def check_slice_settings(settings, frame_height=None, frame_width=None):
    """Raise NotImplementedError for settings outside the ported slice."""
    def unported(what, item):
        raise NotImplementedError(
            '{} is not ported to ysmr_tpu_torch yet (ROADMAP Queue 1 item '
            '{}).'.format(what, item))

    if str(settings.get('transfer mode', 'auto')).lower() == 'frames':
        unported("'transfer mode = frames'", 11)
    if settings['include luminosity in tracking calculation']:
        unported("'include luminosity in tracking calculation'", 10)
    if settings['display video analysis']:
        unported("'display video analysis'", 13)
    if not settings.get('cv2 exact rects', True):
        unported("'cv2 exact rects = False' (the device tracker)", 9)
    if settings['max detections per frame'] > int(
            settings.get('cv2 exact rects max detections', 1024) or 0):
        unported("'max detections per frame' above 'cv2 exact rects max "
                 "detections' (the device tracker)", 9)
    if str(settings.get('wire format', 'auto')).lower() == 'pixels':
        unported("'wire format = pixels'", 10)
    if str(settings.get('run cc', 'auto')).lower() == 'off':
        unported("'run cc = off' (whole-frame labeling)", 11)
    if frame_height is not None and frame_width is not None and \
            frame_height * frame_width >= 1 << 26:
        unported('Frames of 2^26 pixels or more (the pixel wire)', 10)


def resolve_batch_size(settings, device):
    """Frames per device batch: on a GPU small batches round up to 64 (the
    run tables are tiny; a larger batch amortises launches), as the JAX
    package does on an accelerator."""
    batch_size = settings['frame batch size']
    if device.type == 'cuda' and batch_size < 64:
        return 64
    return batch_size


def track_bacteria(video_path, settings=None, result_folder=None,
                   device='cuda'):
    """Detect and track bright spots in a video file, save to _list.csv.

    :param device: 'cuda' (default; raises without a GPU) or 'cpu'
    :return: (df, fps, frame_height, frame_width, csv_path) or None on error
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        logger.critical('No settings provided / could not get settings.')
        return None
    device = resolve_device(device)
    check_slice_settings(settings)
    _require_native()
    get_loggers(log_level=settings['log_level'],
                logfile_name=settings['log file path'],
                short_stream_output=settings['shorten displayed logging output'],
                short_file_output=settings['shorten logfile logging output'],
                log_to_file=settings['log to file'])
    if not os.path.isfile(video_path):
        logger.critical('File %s does not exist', video_path)
        return None
    try:
        probe_reader = BatchedVideoReader(video_path, batch_size=1)
    except VideoReadError as err:
        logger.exception('Problem opening file %s: %s', video_path, err)
        return None
    frame_count = probe_reader.frame_count
    frame_height, frame_width = probe_reader.height, probe_reader.width
    file_fps = probe_reader.fps
    probe_reader._cap.release()
    if frame_count < settings['minimal frame count']:
        logger.warning('File %s too short; file was skipped. Limit for '
                       "'minimal frame count': %s", video_path,
                       settings['minimal frame count'])
        return None
    if not settings['force tracking.ini fps settings']:
        fps_of_file = file_fps
        if settings['verbose'] or fps_of_file != settings['frames per second']:
            logger.info('fps of file: %s', fps_of_file)
        if not fps_of_file or fps_of_file <= 0:
            if settings['frames per second'] <= 0:
                logger.critical('User defined fps unacceptable: %s',
                                settings['frames per second'])
                return None
            fps_of_file = settings['frames per second']
    else:
        fps_of_file = settings['frames per second']

    if not result_folder:
        result_folder = create_results_folder(video_path)
    logger.info('Starting with file %s', video_path)
    old_list, list_name = save_list(
        path=video_path, result_folder=result_folder, first_call=True,
        rename_old_list=settings['rename previous result .csv'])
    if settings['verbose']:
        logger.debug('Frame height: %s, width: %s', frame_height, frame_width)

    preprocess = HostPreprocessor(
        settings, fps_of_file,
        max_fg=settings['max foreground pixels per frame'])
    # striped decode pays off only with spare cores; 'host decode threads'
    # = 0 opts into inline (threadless) decode
    raw_threads = int(settings.get('host decode threads', 1) or 0)
    cpu_n = os.cpu_count() or 1
    decode_threads = max(1, min(raw_threads, cpu_n)) if raw_threads > 0 else 1
    try:
        reader = BatchedVideoReader(
            video_path, batch_size=resolve_batch_size(settings, device),
            prefetch=settings['prefetch batches'],
            color_filter=settings['color filter'],
            preprocess=preprocess,
            decode_mode=settings.get('decode mode', 'exact'),
            decode_threads=decode_threads,
            threaded=raw_threads > 0)
    except VideoReadError as err:
        logger.exception('Problem opening file %s: %s', video_path, err)
        return None
    return _track_loop(reader, settings, fps_of_file, list_name,
                       device=device, old_list=old_list,
                       video_path=video_path)


def _track_loop(reader, settings, fps_of_file, list_name, *, device,
                old_list=False, video_path=None, stats=None):
    """Stage 1 from an opened reader to the sorted ``_list.csv``.

    ``reader`` yields ``{'frames': tables, 'start': int, 'count': int}``
    batches of host-thresholded pixel tables (``HostPreprocessor``) and has
    ``width``, ``height``, ``frame_count``, ``batch_size`` and
    ``preprocess``. ``list_name`` must already hold the CSV header
    (``save_list(first_call=True)``). When ``stats`` is a dict it receives
    the run's counts and host-clock stage times (seconds).

    :return: (df, fps, frame_height, frame_width, csv_path) or None
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    device = resolve_device(device)
    frame_height, frame_width = reader.height, reader.width
    check_slice_settings(settings, frame_height, frame_width)
    _require_native()
    double_threshold = pp.resolve_detection_rule(settings)[0] == \
        'adaptive_double'
    max_det = settings['max detections per frame']
    cc_iters = settings['connected components max iterations']
    batch_size = reader.batch_size
    on_cuda = device.type == 'cuda'
    use_gsff = not settings['disable gsff']
    params = GSFFParams(fps=fps_of_file,
                        n_min=settings['minimum horizon size'],
                        n_max=settings['maximum horizon size'],
                        n_f=settings['number of LSFFs']) if use_gsff else None
    tracker = native_mod.Tracker64(dims=2, max_disappeared=float(fps_of_file),
                                   gsff_params=params)
    runs_buf = runs_cnt = None
    runs_bucket = 512
    # the tracker's detection-slot width: small first, raised once to
    # max_det when a frame exceeds it
    trk_d = min(max_det, 128)
    overflow_warned = False
    capped_frames = 0

    def encode_wire_runs(packed_np, counts_np):
        """Run-length wire of one batch: (T, bucket) uint32 copy + counts."""
        nonlocal runs_buf, runs_cnt, runs_bucket
        b, fcap = packed_np.shape
        if runs_buf is None or runs_buf.shape != (b, fcap):
            runs_buf = np.zeros((b, fcap), np.uint32)
            runs_cnt = np.zeros(b, np.int32)
        ret = native_mod.encode_runs_batch(packed_np, counts_np, runs_buf,
                                           runs_cnt, w=frame_width)
        if ret is None or ret < 0:
            raise RuntimeError('run-length encoding failed ({})'.format(ret))
        if ret > runs_bucket:
            runs_bucket = min(fcap, _next_pow2(int(ret)))
        # the buffers are reused next batch while this batch is in flight
        return runs_buf[:, :runs_bucket].copy(), runs_cnt.copy()

    def stage_detect(data, count, start, frame_valid):
        """Launch one batch's device labeling and the async readback of
        its per-run detection indices; returns the staged batch."""
        counts_np = np.asarray(data['count'])
        runs_np, rc_np = encode_wire_runs(data['px_packed'], counts_np)
        if on_cuda:
            t_start = torch.cuda.Event(enable_timing=True)
            t_start.record()
        px_runs = torch.from_numpy(runs_np.view(np.int32)).to(
            device, non_blocking=True)
        run_counts = torch.from_numpy(rc_np).to(device, non_blocking=True)
        fv = torch.from_numpy(frame_valid).to(device, non_blocking=True)
        tables = detect_from_pixels(
            None, None, None, None, fv, h=frame_height, w=frame_width,
            double_threshold=double_threshold, max_det=max_det,
            max_bh=settings.get('max bounding box height', 96),
            cc_iters=cc_iters, px_runs=px_runs, run_counts=run_counts,
            expanded_f=data['px_packed'].shape[1], use_run_cc=True,
            return_det_px=True, skip_rect=True, det_px_as_runs=True)
        bucket = min(runs_np.shape[1],
                     max(64, _next_pow2(int(rc_np.max()) if count else 1)))
        # one int16 buffer per batch: the per-run indices, then the
        # component count (clamped; only '> max_det' is read) and the
        # propagation step count as two extra columns
        fused = torch.cat(
            [tables['det_run_idx'][:, :bucket],
             tables['n_components'].clamp(max=32767)[:, None].to(torch.int16),
             tables['cc_steps'][:, None].to(torch.int16)], dim=1)
        host = torch.empty(fused.shape, dtype=torch.int16, pin_memory=on_cuda)
        host.copy_(fused, non_blocking=on_cuda)
        staged = {'host': host, 'runs': runs_np, 'run_counts': rc_np,
                  'packed': data['px_packed'], 'counts': counts_np,
                  'start': start, 'frame_valid': frame_valid,
                  'f_bucket': min(data['px_packed'].shape[1], max(
                      256, _next_pow2(int(counts_np.max()) if count else 1)))}
        if on_cuda:
            staged['t_start'] = t_start
            staged['done'] = torch.cuda.Event(enable_timing=True)
            staged['done'].record()
        return staged

    def finish_detect(staged):
        """Wait for a staged batch, measure its rects on the host and track
        them; returns the batch's rows (column arrays) or None."""
        nonlocal trk_d, overflow_warned, capped_frames
        t_a = time.perf_counter()
        if on_cuda:
            staged['done'].synchronize()
            stage_t['device_span'] += staged['t_start'].elapsed_time(
                staged['done']) / 1e3
        fused = staged['host'].numpy()
        det_run = fused[:, :-2]
        n_comp = fused[:, -2].astype(np.int32)
        steps = fused[:, -1].astype(np.int32)
        fv = staged['frame_valid']
        t_b = time.perf_counter()
        stage_t['det_wait'] += t_b - t_a
        capped = int((steps[fv] >= cc_iters).sum())
        if capped:
            capped_frames += capped
            logger.warning(
                '%s frame(s) reached %s run-CC iterations before converging; '
                "raise 'connected components max iterations'.", capped,
                cc_iters)
        if not overflow_warned and (n_comp[fv] > max_det).any():
            overflow_warned = True
            logger.warning(
                'Frame(s) with more than %s detections; extra components '
                "dropped. Raise 'max detections per frame' in [TPU "
                'SETTINGS].', max_det)
        det_px = native_mod.expand_run_det(staged['runs'],
                                           staged['run_counts'], det_run,
                                           staged['f_bucket'])
        max_n = int(n_comp[fv].max()) if fv.any() else 0
        if max_n > trk_d:
            trk_d = max_det
        packed = np.ascontiguousarray(staged['packed'][:, :det_px.shape[1]])
        counts = np.where(fv, staged['counts'], 0).astype(np.int32)
        rects, rvalid = native_mod.cv2_rects_batch(
            packed, counts, det_px, frame_width, trk_d)
        rects = np.where(rvalid[..., None], rects, np.float32(0))
        t_c = time.perf_counter()
        stage_t['rects'] += t_c - t_b
        t_count = int(fv.sum())
        out = tracker.update_batch(rects[:t_count], rvalid[:t_count],
                                   frame0=staged['start'])
        stage_t['tracker'] += time.perf_counter() - t_c
        return out if len(out['TRACK_ID']) else None

    pending = []  # accumulated column arrays awaiting flush
    # every part, kept for the in-memory final sort — bounded: beyond ~16M
    # rows the final sort falls back to the CSV round-trip
    all_parts = []
    all_parts_rows = 0
    max_in_memory_rows = 1 << 24
    pending_rows = 0
    flush_every = settings['list save length interval']
    error_during_read = False
    frames_processed = 0
    stage_t = {'wait_batch': 0.0, 'dispatch': 0.0, 'det_wait': 0.0,
               'rects': 0.0, 'tracker': 0.0, 'csv': 0.0, 'device_span': 0.0}

    def flush():
        nonlocal pending, pending_rows
        if not pending:
            return
        t0 = time.perf_counter()
        arrays = {k: np.concatenate([p[k] for p in pending])
                  for k in pending[0]}
        save_list(arrays=arrays, path=list_name)
        pending = []
        pending_rows = 0
        stage_t['csv'] += time.perf_counter() - t0

    def collect(out):
        nonlocal all_parts, all_parts_rows, pending_rows
        if out is None:
            return
        pending.append(out)
        pending_rows += len(out['TRACK_ID'])
        if all_parts is not None:
            all_parts.append(out)
            all_parts_rows += len(out['TRACK_ID'])
            if all_parts_rows > max_in_memory_rows:
                all_parts = None  # too big; sort from CSV at the end
        if pending_rows >= flush_every:
            flush()

    t_start = time.perf_counter()
    in_flight = None  # the staged batch whose host stage is still to run
    try:
        batches = iter(reader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                break
            t1 = time.perf_counter()
            stage_t['wait_batch'] += t1 - t0
            count = batch['count']
            frame_valid = np.zeros((batch_size,), bool)
            frame_valid[:count] = True
            staged = stage_detect(batch['frames'], count, batch['start'],
                                  frame_valid)
            stage_t['dispatch'] += time.perf_counter() - t1
            frames_processed += count
            if in_flight is not None:
                collect(finish_detect(in_flight))
            in_flight = staged
    except VideoReadError:
        logger.critical('Error during read with file %s', video_path)
        error_during_read = settings['stop evaluation on error']
    if in_flight is not None and not error_during_read:
        collect(finish_detect(in_flight))
    flush()
    preprocess = getattr(reader, 'preprocess', None)
    if preprocess is not None and preprocess.overflowed:
        logger.warning(
            '%s frame(s) exceeded %s foreground pixels; extra pixels dropped. '
            "Raise 'max foreground pixels per frame' in [TPU SETTINGS].",
            preprocess.overflowed, preprocess.max_fg)

    if old_list and error_during_read:
        try:
            os.remove(list_name)
            os.rename(old_list, list_name)
            logger.info('Restoring old list: %s', list_name)
        except (OSError, FileNotFoundError) as file_removal_error:
            logger.error('Error restoring %s: %r', list_name,
                         file_removal_error.args)

    if stats is not None:
        stats.update({'frames': frames_processed,
                      'capped_frames': capped_frames, 'device': str(device),
                      'stage_s': dict(stage_t)})
    last_object_id = tracker.next_id - 1
    if last_object_id < 0:
        logger.warning('Did not track any objects. File: %s', video_path)
        return None

    save_sorted = not settings['delete .csv file after analysis']
    if all_parts and not error_during_read:
        # rows are still in memory: sort + rewrite without the CSV round-trip
        df_for_eval = finalize_sorted_list(all_parts, list_name,
                                           save_file=save_sorted)
    else:
        df_for_eval = sort_list(file_path=list_name, save_file=save_sorted)
    elapsed = time.perf_counter() - t_start
    analysis_fps = frames_processed / elapsed if elapsed > 0 else float('inf')
    if stats is not None:
        stats.update({'elapsed_s': elapsed, 'fps': analysis_fps,
                      'tracks': last_object_id + 1})
    if (settings['verbose'] or settings.get('profile stages')) and \
            frames_processed:
        logger.info('Per-frame stage times (ms): %s', ', '.join(
            '{} {:.2f}'.format(k, v / frames_processed * 1e3)
            for k, v in stage_t.items()))
    logger.info(
        'Average frames analysed per second: %s, objects: %s, frames: %s, csv: %s',
        '{:.2f}'.format(analysis_fps).rjust(6, ' '),
        '{}'.format(last_object_id + 1).rjust(6, ' '),
        '{:>6} of {:>6}'.format(frames_processed, reader.frame_count),
        list_name)
    if error_during_read:
        logger.critical('Error during read, stopping before evaluation. '
                        'File: %s', video_path)
        return None
    return df_for_eval, fps_of_file, frame_height, frame_width, list_name
