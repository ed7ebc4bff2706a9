"""track_bacteria(): video -> _list.csv, stage 1 of the PyTorch port.

Counterpart of ``ysmr_tpu/pipeline/track_bacteria.py::track_bacteria`` in
both transfer modes. In frames mode (``transfer mode = frames``) the
reader decodes raw BGR frames, each batch is uploaded once through a
pinned staging buffer, and the device runs all of detection
(``pipeline/detect.py``: gray, blur, threshold, marker reconstruction and
8-connected labels with the kernels of ``csrc/cc.cu``, compaction, row
tables, hull, exact rect, and with luminosity the exact rect mean) and the
device tracker; the emissions come back as on the device-tracker path
below. ``transfer mode = auto`` picks pixels mode. Pixels mode has two
stage-1 paths. Common to both:

1. host decode and host threshold (native library, in the reader's
   threads): per frame a packed uint32 pixel wire, or with luminosity the
   split int16/uint8 wire plus the gray frame;
2. the run-length wire (native ``encode_runs_batch``), unless ``wire
   format = pixels``, luminosity, or frames of 2^26 pixels or more keep the
   pixel wire;
3. on the device, run-graph connected components (``ops/run_cc.py``, with
   the CUDA kernel ``csrc/run_prop.cu``), or with ``run cc = off``, the
   pixel wire or luminosity the pixel-table branch (``detect_pixels``: per
   pixel labels by the CUDA kernel ``cc_labels_at_pixels`` of
   ``csrc/cc.cu``);
4. one batch in flight: the host finishes batch i - 1 while the device
   works on batch i; each batch comes back in one pinned buffer
   (``non_blocking`` copy plus a CUDA event);
5. ``_list.csv`` (with the ILLUMINATION column under luminosity), appended
   every ``list save length interval`` rows and rewritten sorted at the
   end.

The host-rect path (the default up to ``cv2 exact rects max detections``,
1024, detections per frame; its rows are identical to YSMR's) reads back
one detection index per run (or per pixel on the pixel-table branch) and
measures cv2-exact rects (``native/cv2_exact.cpp``) and tracks in float64
(``native/tracker64.cpp``) on the host. With luminosity the exact rect mean
of each host rect is taken on the device from the uploaded gray frames;
with luminosity and GSFF (which the float64 tracker does not run) the host
rects feed the device tracker. The device-tracker path (denser scenes, or
``cv2 exact rects = False``) measures on the device (``detect_pixels``:
row tables, the hull and sweep kernels ``csrc/hull.cu`` and
``csrc/sweep.cu``, the exact rect, cv2's f32 centers) and tracks there
(``pipeline/tracker.py``, double-single GSFF, the kernel
``csrc/assign.cu``); the padded emissions come back (or, with ``compact
emissions readback``, each frame's live slots packed to the front on the
device, ``tracker.compact_emissions_device``) and
``ReferenceOrderRenumberer`` rewrites their ids into the reference's
registration order.

``display video analysis`` opens the live preview (``pipeline/display.py``)
where a GUI is reachable and warns and runs normally where it is not. An
open preview caps the batch at 16 frames, keeps the decoded frames, takes
the device-rect path, and draws each batch one batch behind, from the host
copies of its detection tables and padded emissions; 'q' stops the run as a
read failure does.

Same contract as the JAX entry point: writes ``_list.csv`` and returns
``(df, fps, frame_height, frame_width, csv_path)``, or None on the errors
the reference reports that way. The device defaults to ``cuda`` and the
call raises without one; CPU runs happen only when a caller passes
``device='cpu'``. ``use table cc`` labels the pixel-table branch (``run
cc = off``, the pixel wire, luminosity) with the sparse table CC, as
``ysmr_tpu`` does; the run-CC branch, frames mode and the multi-video
step ignore it, as there. A missing native library raises (there is no
slower fallback path to take). ``shard dense assignment across devices``
row-shards the device tracker's assignment over the visible devices where
the JAX loop's gate would (``parallel/sharding.py``). ``jax profiler dir``
writes a ``torch.profiler`` Chrome trace of each tracking run into that
directory (``profiled_run``), as the JAX package writes its device trace.
"""

import contextlib
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
from ysmr_tpu_torch.ops.luminosity import rect_mean_luminosity
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.pipeline import tracker as trk
from ysmr_tpu_torch.pipeline.detect import DetectorConfig, detect_batch
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
from ysmr_tpu_torch.pipeline.display import LiveDisplay
from ysmr_tpu_torch.utils.csv_io import (finalize_sorted_list, save_list,
                                         sort_list)
from ysmr_tpu_torch.utils.files import create_results_folder
from ysmr_tpu_torch.utils.logging_utils import get_loggers


#: the compact readback's first bucket of live slots per frame (as JAX)
EMISSIONS_BUCKET = 1024


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


# Copied from ysmr_tpu/pipeline/track_bacteria.py (_compact_emissions).
def _compact_emissions(emissions, batch_start, frame_offset_valid):
    """(T, S) padded emissions -> column arrays sorted by (frame, id)."""
    mask = np.asarray(emissions['mask'])
    ids = np.asarray(emissions['ids'])
    pos = np.asarray(emissions['pos'])
    info = np.asarray(emissions['info'])
    t_len, s = mask.shape
    frames = np.broadcast_to(np.arange(t_len)[:, None], (t_len, s))
    valid_t = frame_offset_valid[:, None] & mask
    sel = np.nonzero(valid_t)
    if sel[0].size == 0:
        return None
    f = frames[sel] + batch_start
    i = ids[sel]
    order = np.lexsort((i, f))
    out = {
        'TRACK_ID': i[order],
        'POSITION_T': f[order],
        'POSITION_X': pos[sel][order][:, 0].astype(np.float64),
        'POSITION_Y': pos[sel][order][:, 1].astype(np.float64),
        'WIDTH': info[sel][order][:, 0].astype(np.float64),
        'HEIGHT': info[sel][order][:, 1].astype(np.float64),
        'DEGREES_ANGLE': info[sel][order][:, 2].astype(np.float64),
    }
    if pos.shape[-1] > 2:
        out['ILLUMINATION'] = pos[sel][order][:, 2].astype(np.float64)
    return out


# Copied from ysmr_tpu/pipeline/track_bacteria.py (_host_rows_from_packed).
def _host_rows_from_packed(packed, counts, k, batch_start,
                           frame_offset_valid, renumberer=None):
    """Rows from the single-buffer device compaction
    (tracker.compact_emissions_device): the first ``counts[t]`` payload
    entries of each frame are the live slots in slot order. Layout per
    payload entry: [id, det_col, pos bits x K, info bits x 3]."""
    b = packed.shape[1] - 1
    ids = packed[:, 1:, 0]
    pos = np.ascontiguousarray(packed[:, 1:, 2:2 + k]).view(np.float32)
    info = np.ascontiguousarray(packed[:, 1:, 2 + k:5 + k]).view(np.float32)
    mask = np.arange(b, dtype=np.int32)[None, :] < counts[:, None]
    if renumberer is not None:
        ids = renumberer.observe_batch(mask, ids, packed[:, 1:, 1],
                                       packed[:, 0, 2], frame_offset_valid)
    return _compact_emissions(
        {'mask': mask, 'ids': ids, 'pos': pos, 'info': info},
        batch_start, frame_offset_valid)


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


@contextlib.contextmanager
def profiled_run(trace_dir, device, name, logger):
    """The tracking run under ``torch.profiler`` when ``jax profiler dir``
    is set (the key keeps its name: both packages read one tracking.ini).
    CPU activity, and the card's with a CUDA ``device``; on every exit,
    an error included, a Chrome trace ``<name>.<pid>.<ns>.pt.trace.json``
    goes into ``trace_dir`` and its path into the log. A profiler that
    cannot start is warned about and the run goes on without it."""
    prof = None
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(trace_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except (RuntimeError, OSError) as err:
            logger.warning('torch profiler not started: %s', err)
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            path = os.path.join(trace_dir, '{}.{}.{}.pt.trace.json'.format(
                name, os.getpid(), time.time_ns()))
            try:
                prof.stop()
                prof.export_chrome_trace(path)
                logger.info('torch profiler trace written to %s', path)
            except (RuntimeError, OSError) as err:
                logger.warning('torch profiler trace not written: %s', err)


def _require_native():
    if not native_mod.available():
        raise RuntimeError('ysmr_tpu_torch needs the native host library '
                           '(native/libysmr_native.so or its build).')


def resolve_transfer_mode(settings):
    """'frames' or 'pixels'. 'auto' stays pixels: the JAX package's link
    probe (``probe_h2d_bandwidth``) is not ported, and frames mode has no
    host-rect path, so letting 'auto' pick frames would take the default
    configuration off its row identity with YSMR (ROADMAP Queue 1 item 6
    decides 'auto' with H100 numbers)."""
    mode = str(settings.get('transfer mode', 'auto')).strip().lower()
    return 'frames' if mode == 'frames' else 'pixels'


def use_host_rects(settings, has_display=False):
    """The JAX loop's gate (``track_bacteria.py:398-406``): in pixels mode
    without an open live display, host rects and the float64 host tracker
    up to ``cv2 exact rects max detections`` detections per frame, unless
    ``cv2 exact rects`` is off; the device rects and tracker above it, in
    frames mode and under the display (which draws the device tables)."""
    cap = int(settings.get('cv2 exact rects max detections', 1024) or 0)
    return resolve_transfer_mode(settings) == 'pixels' and \
        not has_display and \
        settings['max detections per frame'] <= cap and \
        bool(settings.get('cv2 exact rects', True))


def resolve_batch_size(settings, device, has_display=False):
    """Frames per device batch: at most 16 under an open live display (it
    bounds the preview's latency); else on a GPU small batches round up to
    64 (the run tables are tiny; a larger batch amortises launches), as the
    JAX package does on an accelerator."""
    batch_size = settings['frame batch size']
    if has_display:
        return min(batch_size, 16)
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
    display = None
    if settings['display video analysis']:
        display = LiveDisplay(video_path, settings, frame_height, frame_width)
        if not display.enabled:
            display = None  # headless: warned already, run normally
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
        rename_old_list=settings['rename previous result .csv'],
        illumination=settings['include luminosity in tracking calculation'])
    if settings['verbose']:
        logger.debug('Frame height: %s, width: %s', frame_height, frame_width)

    # frames mode ships raw BGR frames: no host threshold
    preprocess = None if resolve_transfer_mode(settings) == 'frames' else \
        HostPreprocessor(settings, fps_of_file,
                         max_fg=settings['max foreground pixels per frame'])
    if preprocess is not None and display is not None:
        preprocess.keep_frames = True  # the preview draws on the frames
    # striped decode pays off only with spare cores; 'host decode threads'
    # = 0 opts into inline (threadless) decode
    raw_threads = int(settings.get('host decode threads', 1) or 0)
    cpu_n = os.cpu_count() or 1
    decode_threads = max(1, min(raw_threads, cpu_n)) if raw_threads > 0 else 1
    try:
        reader = BatchedVideoReader(
            video_path, batch_size=resolve_batch_size(settings, device,
                                                      display is not None),
            prefetch=settings['prefetch batches'],
            color_filter=settings['color filter'],
            preprocess=preprocess,
            decode_mode=settings.get('decode mode', 'exact'),
            decode_threads=decode_threads,
            threaded=raw_threads > 0)
    except VideoReadError as err:
        logger.exception('Problem opening file %s: %s', video_path, err)
        return None
    with profiled_run(settings.get('jax profiler dir') or '', device,
                      os.path.splitext(os.path.basename(video_path))[0],
                      logger):
        return _track_loop(reader, settings, fps_of_file, list_name,
                           device=device, old_list=old_list,
                           video_path=video_path, display=display)


def _track_loop(reader, settings, fps_of_file, list_name, *, device,
                old_list=False, video_path=None, stats=None, display=None):
    """Stage 1 from an opened reader to the sorted ``_list.csv``.

    ``reader`` yields ``{'frames': payload, 'start': int, 'count': int}``
    batches and has ``width``, ``height``, ``frame_count``, ``batch_size``
    and ``preprocess``. The payload is a dict of host-thresholded pixel
    tables (``HostPreprocessor``) in pixels mode, and a (T, H, W, 3) uint8
    array of BGR frames in frames mode (``preprocess`` None). ``list_name``
    must already hold the CSV header (``save_list(first_call=True)``).
    When ``stats`` is a dict it receives
    the run's counts and host-clock stage times (seconds). ``display`` is
    an enabled ``LiveDisplay`` or None; the reader's batches then carry
    the decoded frames (``display_frames``, pixels mode).

    :return: (df, fps, frame_height, frame_width, csv_path) or None
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    device = resolve_device(device)
    frame_height, frame_width = reader.height, reader.width
    _require_native()
    double_threshold = pp.resolve_detection_rule(settings)[0] == \
        'adaptive_double'
    max_det = settings['max detections per frame']
    max_bh = settings.get('max bounding box height', 96)
    cc_iters = settings['connected components max iterations']
    batch_size = reader.batch_size
    on_cuda = device.type == 'cuda'
    use_gsff = not settings['disable gsff']
    params = GSFFParams(fps=fps_of_file,
                        n_min=settings['minimum horizon size'],
                        n_max=settings['maximum horizon size'],
                        n_f=settings['number of LSFFs']) if use_gsff else None
    frames_mode = resolve_transfer_mode(settings) == 'frames'
    host_rects = use_host_rects(settings, display is not None)
    include_lum = bool(settings['include luminosity in tracking calculation'])
    lum_win = settings.get('luminosity window size', 48)
    dims = 3 if include_lum else 2
    # the run wire: raster-order foreground pixels form horizontal runs;
    # its 26-bit start field caps the frame size, and luminosity ships the
    # split wire (its host threshold keeps the gray plane)
    use_runs_wire = not frames_mode and not include_lum and \
        str(settings.get('wire format', 'auto')).lower() != 'pixels' and \
        frame_height * frame_width < (1 << 26)
    # run-graph CC on the run wire unless 'run cc = off' (the kernels
    # exist on every device of the port, so 'auto' is on)
    use_run_cc = use_runs_wire and \
        str(settings.get('run cc', 'auto')).lower() != 'off'
    # the sparse table CC on the pixel-table branch (ignored on run-CC's)
    use_table_cc = bool(settings.get('use table cc', False))
    # the float64 host tracker runs GSFF only in 2-D: luminosity with GSFF
    # takes the device tracker, on the host rects
    native_tracker = host_rects and not (include_lum and use_gsff)
    max_slots = settings['max track slots']
    if native_tracker:
        tracker = native_mod.Tracker64(
            dims=dims, max_disappeared=float(fps_of_file), gsff_params=params)
    else:
        state = trk.init_tracker_state(max_slots, device, dims=dims,
                                       use_gsff=use_gsff, gsff_params=params)
        tracker_kwargs = dict(max_disappeared=float(fps_of_file),
                              use_gsff=use_gsff)
        # the JAX loop's gate of the dense-scene assignment sharding: only
        # with several devices and a slots x detections matrix at or above
        # the threshold (below it the matrix fits one device)
        if bool(settings.get('shard dense assignment across devices',
                             False)):
            n_dev = shd.device_count(device.type)
            if n_dev > 1 and max_slots % n_dev == 0 and \
                    max_slots * max_det >= int(settings.get(
                        'dense assignment shard threshold', 1 << 21)):
                tracker_kwargs['assign_mesh'] = shd.make_mesh(
                    axis='slots', device=device.type)
                logger.debug('Dense assignment row-sharded over %d devices',
                             n_dev)
        if use_gsff:
            tracker_kwargs.update(trk.gsff_kwargs(params, device))
        # device ids rewritten into the reference's registration order
        renumberer = trk.ReferenceOrderRenumberer()
        use_cv2_centers = str(settings.get('cv2 exact centers', 'auto')
                              ).strip().lower() != 'off'
    if frames_mode:
        det_config = DetectorConfig(settings)
        # the mean mode's moving-average window carries across batches
        threshold_state = pp.MovingAverageThreshold(
            fps=fps_of_file, offset=det_config.offset,
            white_on_dark=det_config.white_on_dark) \
            if det_config.mode == 'mean' else None
    logger.debug('Stage-1 path: %s; wire: %s', 'frames: device detection + '
                 'device tracker' if frames_mode else 'host rects + float64 '
                 'tracker' if native_tracker else 'host rects + device '
                 'tracker' if host_rects else 'device rects + device tracker',
                 'runs, run CC' if use_run_cc else 'runs, pixel table'
                 if use_runs_wire else 'pixels, pixel table')
    runs_buf = runs_cnt = None
    runs_bucket = 512
    # the tracker's detection-slot width: small first, raised once to
    # max_det when a frame exceeds it
    trk_d = min(max_det, 128)
    overflow_warned = False
    capped_frames = 0
    # compact readback: each frame's live slots packed to the front on the
    # device, read back in a bucket that grows to the next power of two
    # past the largest live count; a batch past its bucket reads its
    # padded emissions instead. The display keeps the padded arrays.
    compact = display is None and \
        bool(settings.get('compact emissions readback', False))
    em_bucket = min(EMISSIONS_BUCKET, max_slots)
    bucket_growth = []      # (first frame of the batch, old, new bucket)
    fallback_batches = []   # first frames of the batches read padded

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

    def to_dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device, non_blocking=True)

    def upload(data, frame_valid):
        """Start the upload of one batch's wire: the run wire (encoded
        here), the packed pixel wire, or the split wire of luminosity with
        its gray frames. Returns (host-side dict, the wire's keyword
        arguments of ``detect_from_pixels``)."""
        counts_np = np.asarray(data['count'])
        host = {'counts': counts_np, 'runs': None, 'gray': None,
                'fcap': (data['px_packed'] if 'px_packed' in data
                         else data['px_x']).shape[1]}
        kw = {'px_x': None, 'px_y': None, 'px_marker': None,
              'frame_valid': to_dev(frame_valid),
              'px_counts': to_dev(counts_np)}
        if use_runs_wire:
            runs_np, rc_np = encode_wire_runs(data['px_packed'], counts_np)
            kw.update(px_runs=to_dev(runs_np.view(np.int32)),
                      run_counts=to_dev(rc_np), expanded_f=host['fcap'],
                      use_run_cc=use_run_cc)
            host.update(runs=runs_np, run_counts=rc_np)
        elif 'px_packed' in data:
            kw['px_packed'] = to_dev(data['px_packed'].view(np.int32))
        else:
            kw.update(px_x=to_dev(data['px_x']), px_y=to_dev(data['px_y']),
                      px_marker=to_dev(data['px_marker']))
        if include_lum:
            host['gray'] = upload_frames(data['gray'])
        return host, kw

    def detect(kw, **more):
        """``detect_from_pixels`` on one batch's uploaded wire."""
        return detect_from_pixels(
            **kw, **more, h=frame_height, w=frame_width,
            double_threshold=double_threshold, max_det=max_det,
            max_bh=max_bh, cc_iters=cc_iters, use_table=use_table_cc)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pinned_copy(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_cuda)
        host.copy_(t, non_blocking=on_cuda)
        return host

    def to_host(fused, staged, extra=None):
        """One pinned non-blocking copy of the batch's fused buffer (and of
        the tensors of ``extra``, a dict) and the event that marks their
        arrival."""
        staged['host'] = pinned_copy(fused)
        if extra:
            staged['extra'] = {k: pinned_copy(v) for k, v in extra.items()}
        if on_cuda:
            staged['done'] = event()
        return staged

    def wait_host(staged):
        """Wait for a staged batch's readback; returns its host buffer."""
        t_a = time.perf_counter()
        if on_cuda:
            staged['done'].synchronize()
            marks = staged['marks'] + [('readback', staged['done'])]
            stage_t['device_span'] += marks[0][1].elapsed_time(
                staged['done']) / 1e3
            for (_, a), (name, b) in zip(marks, marks[1:]):
                stage_t['device_' + name] += a.elapsed_time(b) / 1e3
        stage_t['det_wait'] += time.perf_counter() - t_a
        return staged['host'].numpy()

    def check_counts(n_comp, steps, fv):
        nonlocal overflow_warned, capped_frames
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

    def stage_detect(data, count, start, frame_valid):
        """Host-rect path: launch one batch's device labeling and the async
        readback of its detection indices (per run on the run-CC branch,
        per pixel on the pixel table); returns the staged batch."""
        marks = [('start', event())] if on_cuda else []
        host, kw = upload(data, frame_valid)
        f_bucket = min(host['fcap'], max(
            256, _next_pow2(int(host['counts'].max()) if count else 1)))
        # one int16 buffer per batch: the detection indices, then the
        # component count (clamped; only '> max_det' is read) and the
        # propagation step count as two extra columns
        if use_run_cc:
            # run-CC's finish writes it, for the runs the host encoded
            fused = detect(kw, readback_runs=min(
                host['runs'].shape[1], max(64, _next_pow2(
                    int(host['run_counts'].max()) if count else 1))))[
                        'readback']
        else:
            # the pixel finish writes it, for the first f_bucket pixels
            fused = detect(kw, readback_pixels=f_bucket)['readback']
        if on_cuda:
            marks.append(('detect', event()))
        if 'px_packed' in data:
            packed = data['px_packed']
        else:       # the split wire: lin from the coordinates
            packed = data['px_y'].astype(np.uint32) * np.uint32(
                frame_width) + data['px_x'].astype(np.uint32)
        return to_host(fused, dict(host, marks=marks, packed=packed,
                                   start=start, frame_valid=frame_valid,
                                   f_bucket=f_bucket))

    def finish_detect(staged):
        """Host-rect path: wait for a staged batch, measure its rects on the
        host (and with luminosity their exact rect means on the device) and
        track them; returns the batch's rows (column arrays) or None."""
        nonlocal trk_d
        fused = wait_host(staged)
        t_b = time.perf_counter()
        det = fused[:, :-2]
        n_comp = fused[:, -2].astype(np.int32)
        fv = staged['frame_valid']
        check_counts(n_comp, fused[:, -1].astype(np.int32), fv)
        if use_run_cc:
            det = native_mod.expand_run_det(staged['runs'],
                                            staged['run_counts'], det,
                                            staged['f_bucket'])
        det_px = np.ascontiguousarray(det)
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
        lum_xy = det_xy_with_rect_lum(staged['gray'], rects, rvalid) \
            if include_lum else None
        if not native_tracker:
            # luminosity with GSFF: the device tracker on the host rects
            marks = [('start', event())] if on_cuda else []
            tables = {'det_xy': lum_xy,
                      'det_info': to_dev(rects[..., 2:5]),
                      'det_valid': to_dev(rvalid),
                      'n_components': torch.from_numpy(n_comp).to(device),
                      'cc_steps': torch.zeros(len(fv), dtype=torch.int32,
                                              device=device)}
            out = finish_track(stage_tracker(tables, marks, staged['start'],
                                             fv, None))
            stage_t['tracker'] += time.perf_counter() - t_c
            return out
        t_count = int(fv.sum())
        lum = lum_xy[..., 2].cpu().numpy()[:t_count] if include_lum \
            else None
        out = tracker.update_batch(rects[:t_count], rvalid[:t_count],
                                   frame0=staged['start'], lum=lum)
        stage_t['tracker'] += time.perf_counter() - t_c
        return out if len(out['TRACK_ID']) else None

    def det_xy_with_rect_lum(gray, rects, rvalid):
        """(T, D, 3) [cx, cy, ILLUMINATION] on the device: the exact rect
        mean of the gray frames at the host-measured rects, so the value
        belongs to the row's own rect (JAX ``_det_xy_with_rect_lum``).
        The rects go up as five contiguous (T, D) columns, in one copy;
        the rect mean is one kernel launch with no host synchronisation."""
        r = to_dev(np.moveaxis(rects, -1, 0))
        lum = rect_mean_luminosity(gray, *r, to_dev(rvalid), win=lum_win)
        return torch.stack([r[0], r[1], lum], dim=-1)

    def stage_track(data, count, start, frame_valid):
        """Device-tracker path: launch one batch's labeling and device
        rects (with luminosity, the exact rect means), then
        ``stage_tracker``; returns the staged batch."""
        marks = [('start', event())] if on_cuda else []
        host, kw = upload(data, frame_valid)
        tables = detect(kw, cv2_centers=use_cv2_centers,
                        include_luminosity=include_lum,
                        gray_frames=host['gray'], lum_win=lum_win)
        if on_cuda:
            marks.append(('detect', event()))
        return stage_tracker(tables, marks, start, frame_valid,
                             (data.get('display_frames'), data))

    # frames mode: two pinned staging buffers, used in turns, and the
    # event after each one's last upload
    pinned = [None, None]
    copied = [None, None]
    n_uploads = 0

    def upload_frames(frames_np):
        """Start the upload of one uint8 batch: BGR frames (T, H, W, 3),
        or the gray frames (T, H, W) of luminosity."""
        nonlocal n_uploads
        if not on_cuda:
            return torch.from_numpy(np.ascontiguousarray(frames_np))
        k = n_uploads % 2
        n_uploads += 1
        if pinned[k] is None or tuple(pinned[k].shape) != frames_np.shape:
            pinned[k] = torch.empty(frames_np.shape, dtype=torch.uint8,
                                    pin_memory=True)
        elif copied[k] is not None:
            copied[k].synchronize()     # its last upload has left it
        pinned[k].numpy()[...] = frames_np
        frames = pinned[k].to(device, non_blocking=True)
        copied[k] = event()
        return frames

    def stage_frames(frames_np, count, start, frame_valid):
        """Frames mode: upload one batch of BGR frames, launch its device
        detection, then ``stage_tracker``; returns the staged batch."""
        marks = [('start', event())] if on_cuda else []
        frames = upload_frames(frames_np)
        fv = torch.from_numpy(frame_valid).to(device, non_blocking=True)
        tables = detect_batch(frames, fv, det_config,
                              threshold_state=threshold_state)
        if on_cuda:
            marks.append(('detect', event()))
        return stage_tracker(tables, marks, start, frame_valid,
                             (frames_np, None))

    def stage_tracker(tables, marks, start, frame_valid, shown):
        """Launch the tracker scan over one batch's detection tables and
        the async readback of its emissions in one int32 buffer: padded,
        or packed by ``compact_emissions_device``. Under the display also
        the host copies of the detection tables, and ``shown`` (the
        batch's frames and its host wire) rides along. Returns the staged
        batch."""
        nonlocal state
        state, em = trk.run_tracker_scan(
            state, tables['det_xy'], tables['det_info'], tables['det_valid'],
            **tracker_kwargs)
        if on_cuda:
            marks.append(('track', event()))
        t_len = em['mask'].shape[0]
        # frames mode reports no step counts (0), as the JAX one: the
        # kernels have no cap, and the plain labeling stops at the cap
        # without a warning, as the JAX CPU path does
        steps = tables.get('cc_steps')
        if steps is None:
            steps = torch.zeros_like(tables['n_components'])
        staged = {'marks': marks, 'start': start, 'frame_valid': frame_valid,
                  't': t_len, 'k': em['pos'].shape[2]}
        if compact:
            # [T, bucket + 1, 5 + K] (tracker.compact_emissions_device),
            # then per frame cc_steps; the padded emissions stay on the
            # device for a batch that overflows the bucket
            packed = trk.compact_emissions_device(
                em, tables['n_components'], bucket=em_bucket)
            fused = torch.cat([packed.reshape(-1), steps.to(torch.int32)])
            staged.update(bucket=packed.shape[1] - 1, padded=em)
            return to_host(fused, staged)
        # per slot [mask, id, det_col, x, y, w, h, angle] (floats as their
        # int32 bits), then per frame [n_det, n_components, cc_steps]
        slots = torch.cat(
            [em['mask'][..., None].to(torch.int32), em['ids'][..., None],
             em['det_col'][..., None], em['pos'].view(torch.int32),
             em['info'].view(torch.int32)], dim=2)
        frames = torch.stack([em['n_det'], tables['n_components'], steps],
                             dim=1).to(torch.int32)
        fused = torch.cat([slots.reshape(-1), frames.reshape(-1)])
        extra = None
        if display is not None and shown is not None:
            staged['shown'] = shown
            extra = {k: tables[k] for k in ('det_xy', 'det_info',
                                            'det_valid')}
        return to_host(fused, staged, extra)

    def show(staged, mask, ids, pos):
        """Draw a read-back batch on the live display (device ids, as the
        JAX loop draws them)."""
        frames, wire = staged['shown']
        det_host = {k: v.numpy() for k, v in staged['extra'].items()}
        if wire is not None:
            for key in ('px_x', 'px_y', 'px_marker', 'px_packed', 'count'):
                if key in wire:
                    det_host[key] = np.asarray(wire[key])
        fps = frames_processed / max(time.perf_counter() - t_start, 1e-9)
        display.show_batch(frames, int(staged['frame_valid'].sum()),
                           det_host, {'mask': mask, 'ids': ids, 'pos': pos},
                           fps)

    def finish_track(staged):
        """Device-tracker path: wait for a staged batch's emissions, draw it
        on the display, and turn them into rows (ids renumbered); returns
        the rows or None."""
        nonlocal em_bucket
        buf = wait_host(staged)
        t_b = time.perf_counter()
        t_len, k = staged['t'], staged['k']
        fv = staged['frame_valid']
        bucket = staged.get('bucket')
        if bucket is not None:
            packed = buf[:-t_len].reshape(t_len, bucket + 1, 5 + k)
            counts = packed[:, 0, 0]
            check_counts(packed[:, 0, 1], buf[-t_len:], fv)
            cmax = int(counts.max(initial=0))
            if cmax > em_bucket:
                new_bucket = min(max_slots, _next_pow2(cmax))
                bucket_growth.append((staged['start'], em_bucket,
                                      new_bucket))
                em_bucket = new_bucket
            if cmax <= bucket:
                out = _host_rows_from_packed(packed, counts, k,
                                             staged['start'], fv,
                                             renumberer=renumberer)
                stage_t['emit_rows'] += time.perf_counter() - t_b
                return out
            # past the bucket: this batch's padded emissions
            fallback_batches.append(staged['start'])
            em = {key: v.cpu().numpy() for key, v in staged['padded'].items()}
            mask, ids, det_col, n_det = (em[key] for key in
                                         ('mask', 'ids', 'det_col', 'n_det'))
            pos, info = em['pos'], em['info']
        else:
            width = 3 + k + 3
            n_slot = (buf.shape[0] - 3 * t_len) // (t_len * width)
            slots = buf[:t_len * n_slot * width].reshape(t_len, n_slot,
                                                         width)
            frames = buf[t_len * n_slot * width:].reshape(t_len, 3)
            check_counts(frames[:, 1], frames[:, 2], fv)
            mask = slots[:, :, 0] > 0
            ids, det_col, n_det = slots[:, :, 1], slots[:, :, 2], frames[:, 0]
            floats = np.ascontiguousarray(slots[:, :, 3:]).view(np.float32)
            pos, info = floats[:, :, :k], floats[:, :, k:]
            if 'shown' in staged and display.enabled:
                show(staged, mask, ids, pos)
        ids = renumberer.observe_batch(mask, ids, det_col, n_det, fv)
        out = _compact_emissions({'mask': mask, 'ids': ids, 'pos': pos,
                                  'info': info}, staged['start'], fv)
        stage_t['emit_rows'] += time.perf_counter() - t_b
        return out

    if frames_mode:
        stage, finish = stage_frames, finish_track
    elif host_rects:
        stage, finish = stage_detect, finish_detect
    else:
        stage, finish = stage_track, finish_track
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
               'rects': 0.0, 'tracker': 0.0, 'emit_rows': 0.0, 'csv': 0.0,
               'device_span': 0.0, 'device_detect': 0.0,
               'device_track': 0.0, 'device_readback': 0.0}

    def flush():
        nonlocal pending, pending_rows
        if not pending:
            return
        t0 = time.perf_counter()
        arrays = {k: np.concatenate([p[k] for p in pending])
                  for k in pending[0]}
        save_list(arrays=arrays, path=list_name, illumination=include_lum)
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

    def interrupted():
        """'q' on the live display: the run stops as on a read error."""
        if display is None or not display.interrupted:
            return False
        logger.error('Processing file interrupted by user: %s', video_path)
        return True

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
            staged = stage(batch['frames'], count, batch['start'],
                           frame_valid)
            stage_t['dispatch'] += time.perf_counter() - t1
            frames_processed += count
            if in_flight is not None:
                out = finish(in_flight)
                if interrupted():
                    error_during_read = True
                    break
                collect(out)
            in_flight = staged
    except VideoReadError:
        logger.critical('Error during read with file %s', video_path)
        error_during_read = settings['stop evaluation on error']
    if in_flight is not None and not error_during_read:
        out = finish(in_flight)
        if interrupted():
            error_during_read = True
        else:
            collect(out)
    flush()
    if display is not None:
        display.close()
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

    # the float64 host tracker has no slot cap, so nothing can be dropped
    # there
    dropped = 0 if native_tracker else int(state['dropped_registrations'])
    if dropped:
        logger.warning('%s registrations dropped (track slot capacity %s '
                       "reached); raise 'max track slots' in [TPU SETTINGS].",
                       dropped, max_slots)
    if stats is not None:
        stats.update({'frames': frames_processed,
                      'transfer_mode': 'frames' if frames_mode else 'pixels',
                      'capped_frames': capped_frames, 'device': str(device),
                      'host_rects': host_rects,
                      'dropped_registrations': dropped,
                      'readback': 'compact' if compact else 'padded',
                      'bucket_growth': list(bucket_growth),
                      'fallback_batches': list(fallback_batches),
                      'stage_s': dict(stage_t)})
    last_object_id = (tracker.next_id if native_tracker
                      else int(state['next_id'])) - 1
    if last_object_id < 0:
        logger.warning('Did not track any objects. File: %s', video_path)
        return None

    save_sorted = not settings['delete .csv file after analysis']
    if all_parts and not error_during_read:
        # rows are still in memory: sort + rewrite without the CSV round-trip
        df_for_eval = finalize_sorted_list(all_parts, list_name,
                                           illumination=include_lum,
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
