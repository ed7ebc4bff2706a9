# Copied from ysmr_tpu/parallel/multi_video.py; the differences are the
# device argument, the port's mesh and tracker state (parallel/sharding.py),
# and the readback of each device's emission block.
"""Sharded multi-video tracking: stage 1 for N videos over a device mesh.

The replacement for the reference's per-video process pool (main.py:281-313,
``mp.Pool(maxtasksperchild=1)``): a batch of videos is split over the
``videos`` axis of a ``parallel.sharding.Mesh`` and every device runs
frames-mode detection and the tracker on its own videos
(``sharding.make_multi_video_step``). Host decode feeds all videos
concurrently; per-video tracker state is carried across frame batches, so
videos of any length stream through in fixed-size steps; each video still
produces its own ``_list.csv`` with the bytes of a solo frames-mode run.

Videos are grouped by (height, width, fps): geometry fixes the array shapes
and fps fixes the tracker/GSFF constants. Groups run one after another;
within a group the video axis is padded up to a mesh-size multiple with
inert all-invalid videos whose emissions are discarded, and a video that
has ended keeps being stepped with invalid frames until the group's
longest one ends. Mean-threshold mode runs each video solo through
``track_bacteria``. The run is one process: every shard of the mesh is
local.
"""

import logging
import os
import time

import numpy as np

from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.io.video import BatchedVideoReader, VideoReadError
from ysmr_tpu_torch.ops.gsff import GSFFParams
from ysmr_tpu_torch.ops.preprocess import resolve_detection_rule
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.pipeline import detect as det
from ysmr_tpu_torch.pipeline import tracker as trk
from ysmr_tpu_torch.pipeline.track_bacteria import (_compact_emissions,
                                                    resolve_device,
                                                    track_bacteria)
from ysmr_tpu_torch.utils.csv_io import finalize_sorted_list, save_list, sort_list
from ysmr_tpu_torch.utils.files import create_results_folder
from ysmr_tpu_torch.utils.logging_utils import get_loggers

__all__ = ['track_videos_sharded']


def _resolve_fps(probe, settings, log):
    """The effective fps for a clip, honouring the force/fallback settings
    (same rules as track_bacteria, reference track_eval.py:78-93)."""
    if settings['force tracking.ini fps settings']:
        return settings['frames per second']
    fps = probe.fps
    if not fps or fps <= 0:
        fps = settings['frames per second']
        if fps <= 0:
            return None
    return fps


def _probe_videos(paths, settings, log):
    """Open each clip once for geometry/fps/frame-count validation.

    :return: (metas {path: dict}, failed [paths])
    """
    metas, failed = {}, []
    for path in paths:
        if not os.path.isfile(path):
            log.critical('File %s does not exist', path)
            failed.append(path)
            continue
        try:
            probe = BatchedVideoReader(path, batch_size=1)
        except VideoReadError as err:
            log.exception('Problem opening file %s: %s', path, err)
            failed.append(path)
            continue
        meta = {'height': probe.height, 'width': probe.width,
                'frame_count': probe.frame_count}
        probe._cap.release()
        if meta['frame_count'] < settings['minimal frame count']:
            log.warning("File %s too short; file was skipped. Limit for "
                        "'minimal frame count': %s", path,
                        settings['minimal frame count'])
            failed.append(path)
            continue
        fps = _resolve_fps(probe, settings, log)
        if fps is None:
            log.critical('No usable fps for %s (file reports none and the '
                         'settings fps is %s)', path,
                         settings['frames per second'])
            failed.append(path)
            continue
        meta['fps'] = float(fps)
        metas[path] = meta
    return metas, failed


class _VideoRun:
    """Host-side bookkeeping for one video inside a sharded group."""

    def __init__(self, path, meta, settings, result_folder, log):
        self.path = path
        self.meta = meta
        self.log = log
        self.ok = True
        self.finished = False
        self.frames_seen = 0
        self.pending = []
        self.pending_rows = 0
        self.all_parts = []
        self.overflow_warned = False
        self.flush_every = settings['list save length interval']
        # per-video readback renumbering into the reference's CPython-set
        # registration order (pipeline/tracker.ReferenceOrderRenumberer)
        self.renumberer = trk.ReferenceOrderRenumberer()
        self.old_list, self.list_name = save_list(
            path=path, result_folder=result_folder, first_call=True,
            rename_old_list=settings['rename previous result .csv'],
            illumination=settings['include luminosity in tracking calculation'])
        try:
            self.reader = BatchedVideoReader(
                path, batch_size=settings['frame batch size'],
                prefetch=settings['prefetch batches'],
                color_filter=settings['color filter'],
                decode_mode=settings.get('decode mode', 'exact'))
            self._batches = iter(self.reader)
        except VideoReadError as err:
            log.exception('Problem opening file %s: %s', path, err)
            self.ok = False
            self.finished = True
            self.reader = None
            self._batches = iter(())

    def next_batch(self):
        """(frames or None, valid (B,) bool, start). None = no more frames."""
        if self.finished:
            return None, None, 0
        try:
            batch = next(self._batches, None)
        except VideoReadError:
            self.log.critical('Error during read with file %s', self.path)
            self.finished = True
            self.ok = False  # stop-on-error semantics applied by caller
            return None, None, 0
        if batch is None:
            self.finished = True
            return None, None, 0
        count = batch['count']
        valid = np.zeros((batch['frames'].shape[0],), bool)
        valid[:count] = True
        self.frames_seen += count
        return batch['frames'], valid, batch['start']

    def collect(self, emissions_v, start, valid, n_components, max_det):
        """Compact one read-back batch of emissions into pending CSV rows."""
        if not self.ok:
            return
        if not self.overflow_warned and \
                (n_components[valid] > max_det).any():
            self.overflow_warned = True
            self.log.warning(
                'Frame(s) of %s with more than %s detections; extra '
                "components dropped. Raise 'max detections per frame' in "
                '[TPU SETTINGS].', self.path, max_det)
        emissions_v = dict(emissions_v)
        emissions_v['ids'] = self.renumberer.observe_batch(
            emissions_v['mask'], emissions_v['ids'], emissions_v['det_col'],
            emissions_v['n_det'], valid)
        out = _compact_emissions(emissions_v, start, valid)
        if out is None:
            return
        self.pending.append(out)
        self.all_parts.append(out)
        self.pending_rows += len(out['TRACK_ID'])
        if self.pending_rows >= self.flush_every:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        arrays = {k: np.concatenate([p[k] for p in self.pending])
                  for k in self.pending[0]}
        save_list(arrays=arrays, path=self.list_name,
                  illumination='ILLUMINATION' in arrays)
        self.pending = []
        self.pending_rows = 0

    def finalize(self, state_v, settings, elapsed):
        """Close out the artifacts; returns the track_bacteria-style tuple."""
        self.flush()
        include_lum = settings['include luminosity in tracking calculation']
        if not self.ok and settings['stop evaluation on error']:
            if self.old_list:
                try:
                    os.remove(self.list_name)
                    os.rename(self.old_list, self.list_name)
                    self.log.info('Restoring old list: %s', self.list_name)
                except OSError as err:
                    self.log.error('Error restoring %s: %r', self.list_name,
                                   err.args)
            self.log.critical('Error during read, stopping before '
                              'evaluation. File: %s', self.path)
            return None
        dropped = int(state_v['dropped_registrations'])
        if dropped:
            self.log.warning(
                '%s registrations dropped for %s (track slot capacity '
                "reached); raise 'max track slots' in [TPU SETTINGS].",
                dropped, self.path)
        last_id = int(state_v['next_id']) - 1
        if last_id < 0:
            self.log.warning('Did not track any objects. File: %s', self.path)
            return None
        save_sorted = not settings['delete .csv file after analysis']
        if self.all_parts:
            df = finalize_sorted_list(self.all_parts, self.list_name,
                                      illumination=include_lum,
                                      save_file=save_sorted)
        else:
            df = sort_list(file_path=self.list_name, save_file=save_sorted)
        fps = self.frames_seen / elapsed if elapsed > 0 else float('inf')
        self.log.info(
            'Average frames analysed per second: %s, objects: %s, frames: '
            '%s, csv: %s (sharded batch)',
            '{:.2f}'.format(fps).rjust(6, ' '),
            '{}'.format(last_id + 1).rjust(6, ' '),
            '{:>6} of {:>6}'.format(self.frames_seen,
                                    self.meta['frame_count']),
            self.list_name)
        return (df, self.meta['fps'], self.meta['height'],
                self.meta['width'], self.list_name)


#: the emission columns a video's rows are made of
_EMITTED = ('mask', 'ids', 'pos', 'info', 'det_col', 'n_det', 'n_components')


def _run_group(paths, metas, settings, result_folder, mesh, log):
    """One sharded run over videos sharing (height, width, fps)."""
    t_start = time.perf_counter()
    fps = metas[paths[0]]['fps']
    h, w = metas[paths[0]]['height'], metas[paths[0]]['width']
    n_dev = mesh.size
    v = len(paths)
    v_pad = -(-v // n_dev) * n_dev
    per = v_pad // n_dev
    batch_size = settings['frame batch size']
    log.info('Sharded batch: %s video(s) at %sx%s@%sfps over %s device(s) '
             '(video axis padded to %s).', v, w, h, fps, n_dev, v_pad)

    config = det.DetectorConfig(settings)
    use_gsff = not settings['disable gsff']
    dims = 3 if config.include_luminosity else 2
    max_slots = settings['max track slots']
    tracker_kwargs = dict(max_disappeared=float(fps), use_gsff=use_gsff)
    params = GSFFParams(fps=fps, n_min=settings['minimum horizon size'],
                        n_max=settings['maximum horizon size'],
                        n_f=settings['number of LSFFs']) if use_gsff else None
    state0 = trk.init_tracker_state(max_slots, 'cpu', dims=dims,
                                    use_gsff=use_gsff, gsff_params=params)
    if use_gsff:
        tracker_kwargs.update(trk.gsff_kwargs(params, 'cpu'))
    state = shd.shard_videos(mesh, shd.stack_states([state0] * v_pad))

    detect_kwargs = dict(mode=config.mode, white_on_dark=config.white_on_dark,
                         offset=config.offset,
                         double_delta=config.double_delta,
                         max_det=config.max_det, max_bh=config.max_bh,
                         cc_iters=config.cc_iters,
                         include_luminosity=config.include_luminosity,
                         lum_win=config.lum_win)
    step = shd.make_multi_video_step(mesh, detect_kwargs=detect_kwargs,
                                     tracker_kwargs=tracker_kwargs)

    runs = [_VideoRun(p, metas[p], settings, result_folder, log)
            for p in paths]
    frames_buf = np.zeros((v_pad, batch_size, h, w, 3), np.uint8)
    while True:
        valid_buf = np.zeros((v_pad, batch_size), bool)
        starts = [0] * v
        any_live = False
        for i, run in enumerate(runs):
            frames, valid, start = run.next_batch()
            if frames is None:
                frames_buf[i, :] = 0
                continue
            any_live = True
            frames_buf[i] = frames
            valid_buf[i] = valid
            starts[i] = start
        if not any_live:
            break
        state, emissions = step(shd.shard_videos(mesh, frames_buf),
                                shd.shard_videos(mesh, valid_buf), state)
        # every device was enqueued; now each block comes back
        host = [{k: block[k].cpu().numpy() for k in _EMITTED}
                for block in emissions]
        for i, run in enumerate(runs):
            if not valid_buf[i].any():
                continue
            em = host[i // per]
            emissions_v = {k: em[k][i % per] for k in _EMITTED}
            run.collect(emissions_v, starts[i], valid_buf[i],
                        emissions_v['n_components'], config.max_det)

    state_host = {k: np.concatenate([block[k].cpu().numpy()
                                     for block in state])
                  for k in ('dropped_registrations', 'next_id')}
    elapsed = time.perf_counter() - t_start
    results = {}
    for i, run in enumerate(runs):
        state_v = {k: state_host[k][i] for k in state_host}
        results[run.path] = run.finalize(state_v, settings, elapsed)
    return results


def track_videos_sharded(paths, settings=None, result_folder=None, mesh=None,
                         device='cuda'):
    """Run stage 1 (detect+track -> ``_list.csv``) for many videos at once,
    data-parallel over a device mesh.

    Capability replacement for dispatching ``track_bacteria`` through a
    process pool: per-video outputs are independent and equal solo
    frames-mode runs. Mean-threshold mode carries host-side moving-average
    state per frame in strict order, which does not batch across videos —
    such runs fall back to solo tracking per video.

    :param paths: video file paths (any mix of geometries/fps; grouped)
    :param mesh: optional prebuilt 1-axis mesh; defaults to every device of
        ``device``'s kind (``sharding.make_mesh``). The run is one process:
        a mesh over a ``torch.distributed`` group of several processes
        raises, since each would hold only its own videos' emissions
    :param device: 'cuda' (default; raises without a GPU) or 'cpu'
    :return: {path: (df, fps, frame_height, frame_width, csv_path) | None}
    """
    device = resolve_device(device)
    log = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        log.critical('No settings provided / could not get settings.')
        return {p: None for p in paths}
    get_loggers(log_level=settings['log_level'],
                logfile_name=settings['log file path'],
                short_stream_output=settings['shorten displayed logging output'],
                short_file_output=settings['shorten logfile logging output'],
                log_to_file=settings['log to file'])
    results = {}

    mode, _ = resolve_detection_rule(settings)
    if mode == 'mean':
        log.info('Mean-threshold mode is sequential per video; running the '
                 'batch solo instead of sharded.')
        for path in paths:
            results[path] = track_bacteria(path, settings, result_folder,
                                           device=device)
        return results

    if mesh is None:
        mesh = shd.make_mesh(device=device.type)
    if (mesh.world or 1) > 1:
        raise ValueError('track_videos_sharded runs in one process; {} spans '
                         '{} processes'.format(mesh, mesh.world))
    if result_folder is None and paths:
        result_folder = create_results_folder(paths[0])
    metas, failed = _probe_videos(paths, settings, log)
    results.update({p: None for p in failed})
    if not metas:
        return results

    groups = {}
    for path, meta in metas.items():
        groups.setdefault((meta['height'], meta['width'], meta['fps']),
                          []).append(path)
    for key in sorted(groups):
        group_paths = groups[key]
        results.update(_run_group(group_paths, metas, settings,
                                  result_folder, mesh, log))
    return results
