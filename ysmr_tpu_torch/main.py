# Copied from ysmr_tpu/main.py; the differences are the device argument,
# the pool without a JAX initializer and the logging listener's teardown
# when a dispatch raises.
#!/usr/bin/env python3
"""Batch orchestration: the ``ysmr()`` entry point and per-file ``analyse()``.

Capability parity with the reference's main module (main.py:32-331): same public
signatures, artifact set (stage CSVs, ``_meta.json`` sidecar, xlsx collation,
dated results folders), skip/restart semantics, per-path failure isolation,
and optional machine shutdown. The flow here is organised as an explicit
stage chain (`_run_stage_chain`) driven by small predicate helpers rather
than the reference's single inline function body.

Device note: ``ysmr()`` and ``analyse()`` take ``device`` ('cuda' by
default, which raises without a GPU; 'cpu' runs the plain PyTorch path)
and hand it to ``track_bacteria``. Pool workers run on the device the
caller named: a GPU is shared between processes, so each spawn worker opens
its own CUDA context, and a worker that cannot open one raises (its file
counts as failed). ``shard videos across devices`` with several paths
runs stage 1 for every video at once over the devices of ``device``'s kind
(``parallel/multi_video.py``) in place of the pool.
"""

import logging
import multiprocessing as mp
import os
from datetime import datetime
from time import sleep

from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded
from ysmr_tpu_torch.pipeline.annotate import annotate_video
from ysmr_tpu_torch.pipeline.evaluate import evaluate_tracks
from ysmr_tpu_torch.pipeline.select import select_tracks
from ysmr_tpu_torch.pipeline.track_bacteria import (resolve_device,
                                                    track_bacteria)
from ysmr_tpu_torch.utils.csv_io import collate_results_csv_to_xlsx
from ysmr_tpu_torch.utils.files import (create_results_folder, elapsed_time, get_any_paths,
                                  metadata_file)
from ysmr_tpu_torch.utils.logging_utils import (check_logfile, get_loggers, log_infos,
                                          logging_listener, shutdown,
                                          stop_logging_queue)

__all__ = ['analyse', 'ysmr']

# Substrings marking files that are themselves outputs of a finished run;
# handing one back in is a no-op (reference main.py:83-87).
_FINISHED_MARKERS = ('_analysed.csv', '_statistics.csv', '_annotated_output.')

# Any of these flags being truthy means the evaluation stage must run
# (reference main.py:65-78 computes the same union).
_EVAL_OUTPUT_FLAGS = (
    'store generated statistical .csv file',
    'store final analysed .csv file',
    'save large plots',
    'save rose plot',
    'save time violin plot',
    'save acr violin plot',
    'save length violin plot',
    'save turning point violin plot',
    'save speed violin plot',
    'save angle distribution plot / bins',
    'collate results csv to xlsx',
    'save video',
)


class _StageFailed(Exception):
    """Internal short-circuit: a stage failed or the file must be skipped.

    The failing stage has already logged the cause; the pipeline result is
    ``None``.
    """


def _attach_loggers(settings):
    """Route the 'ysmr' logger per the settings (queue-aware, idempotent)."""
    get_loggers(log_level=settings['log_level'],
                logfile_name=settings['log file path'],
                short_stream_output=settings['shorten displayed logging output'],
                short_file_output=settings['shorten logfile logging output'],
                log_to_file=settings['log to file'],
                settings=settings)


def _evaluation_requested(settings):
    return any(bool(settings[flag]) for flag in _EVAL_OUTPUT_FLAGS)


def _discard_quietly(csv_file, log):
    try:
        os.remove(csv_file)
    except FileNotFoundError:
        pass
    except OSError:
        log.exception('Could not delete the intermediate csv: %s', csv_file)


def _run_stage_chain(path, settings, folder, meta_kwargs, log, device,
                     staged=None):
    """Run the per-file stages in order; returns (result, tracker_csv).

    Raises ``_StageFailed`` when a stage errors out or the file is skipped.
    ``staged`` optionally carries a precomputed stage-1 result.
    """
    if any(marker in path for marker in _FINISHED_MARKERS):
        log.warning('Skipping %s — it is an output of a previous run.', path)
        raise _StageFailed
    takes_video_stage = '.csv' not in path
    fps = meta_kwargs.pop('fps', None)
    height = meta_kwargs.pop('frame_height', None)
    width = meta_kwargs.pop('frame_width', None)

    df, tracker_csv = None, None
    if takes_video_stage:
        if staged is None:
            if settings['verbose']:
                log.debug('Treating %s as a video (no .csv extension).', path)
            staged = track_bacteria(video_path=path, settings=settings,
                                    result_folder=folder, device=device)
        if staged is None:
            log.warning('Detection/tracking stage failed on %s.', path)
            raise _StageFailed
        df, fps, height, width, tracker_csv = staged

    # sidecar lookup/merge: explicit values win over stored ones
    meta = metadata_file(path=os.path.join(folder, os.path.basename(path)),
                        additional_search_paths=path,
                        verbose=settings['verbose'],
                        fps=fps, frame_height=height, frame_width=width,
                        **meta_kwargs)
    if settings['debugging']:
        for item in meta.items():
            log.debug('meta %s = %s', *item)

    evaluate = _evaluation_requested(settings)
    result = df
    if 'selected_data.csv' not in path:
        if evaluate or settings['store processed .csv file']:
            df = select_tracks(path_to_file=path, df=df,
                               results_directory=folder,
                               settings=settings, **meta)
            if df is None:
                log.warning('Track selection stage failed on %s.', path)
                raise _StageFailed
            result = df
    elif not evaluate:
        log.warning('Nothing to do for %s: settings enable no evaluation '
                    'outputs.', path)
    if evaluate:
        result = evaluate_tracks(path_to_file=path, results_directory=folder,
                                 df=df, settings=settings, **meta)
        if settings['save video']:
            if takes_video_stage:
                annotate_video(video_path=path, df=result[0],
                               settings=settings, result_folder=folder)
            else:
                log.warning("'save video' requires the original video but %s "
                            'is a .csv; run annotate_video() on the source '
                            'clip directly.', path)
    return result, tracker_csv


def analyse(path, settings=None, result_folder=None, return_df=False,
            device='cuda', _staged=None, **kwargs):
    """Run the appropriate pipeline stages for one file (video or .csv).

    :param device: 'cuda' (default; raises without a GPU) or 'cpu'
    :param kwargs: extra metadata, persisted to the ``_meta.json`` sidecar
    :return: df (or True when ``return_df`` is falsy) on success, None on error
    """
    started = datetime.now()
    device = resolve_device(device)
    settings = get_configs(settings)
    if settings is None:
        return None
    _attach_loggers(settings)
    log = logging.getLogger('ysmr').getChild(__name__)
    if result_folder is None:
        result_folder = create_results_folder(path)
    else:
        os.makedirs(result_folder, exist_ok=True)
    log.debug('analyse() pid %s writing to %s', os.getpid(), result_folder)

    result, tracker_csv = None, None
    try:
        result, tracker_csv = _run_stage_chain(path, settings, result_folder,
                                               kwargs, log, device,
                                               staged=_staged)
    except _StageFailed:
        result = None
    if tracker_csv and settings['delete .csv file after analysis']:
        _discard_quietly(tracker_csv, log)

    succeeded = result is not None
    log.info('%s %s after %s (pid %s)',
             'Done with' if succeeded else 'Gave up on',
             os.path.basename(path), elapsed_time(started), os.getpid())
    if succeeded and not return_df:
        return True
    return result


def _spawn_log_listener(settings):
    """Start the dedicated logging-listener process (spawn context).

    Spawn, not fork: the parent typically holds a CUDA context and torch's
    threads by the time ``ysmr()`` runs; CUDA does not survive a fork, and
    forking a multi-threaded process is unsafe (and deprecation-warned on
    py3.12).
    """
    ctx = mp.get_context('spawn')
    settings['logging_queue'] = ctx.Manager().Queue(-1)
    listener = ctx.Process(target=logging_listener, args=(settings,))
    listener.start()
    return listener


def _debug_fast_path(paths, settings, log, device):
    """'debugging' mode: run the configured test clip directly, no prompts."""
    clip = paths[0] if paths else os.path.expanduser(
        settings['path to test video'])
    if os.path.isfile(clip):
        log.info('Debug run on %s', clip)
    else:
        log.critical('Debug clip not found, trying anyway: %s', clip)
    folder = create_results_folder(path=settings['path to test video'])
    return analyse(path=clip, settings=settings, result_folder=folder,
                   device=device)


def _resolve_paths(paths, settings, log):
    """Determine the work list: caller-provided, Tk-selected, or test clip."""
    if not paths:
        if settings['select files']:
            paths = get_any_paths(rename=True, settings=settings)
            if not paths:
                log.critical('File selection returned nothing; stopping.')
                return None
        else:
            paths = [settings['path to test video']]
            log.info('No paths given; falling back to the test video.')
    paths = [os.path.expanduser(p) for p in paths]
    log.info('Queued %s file(s):', len(paths))
    for p in paths:
        log.debug('  %s', p)
    return paths


def _confirm_interactive(settings, log):
    """Y/N gate before touching files, when 'user input' is enabled."""
    while settings['user input']:
        sleep(.1)
        answer = input('Continue? (Y/N): ').strip().lower()[:3]
        if answer.startswith('y'):
            log.debug('Confirmed by user.')
            return True
        if answer.startswith('n'):
            log.info('Cancelled by user.\n')
            return False
    return True


def _dispatch_pool(paths, settings, folder, log, device):
    """One spawn worker per file, maxtasksperchild=1 (worker isolation as in
    reference main.py:281-313); returns {path: AsyncResult}. Each worker
    opens its own context on ``device``."""
    log.info('Process-pool workers run on %s, one context each.', device)
    pool = mp.get_context('spawn').Pool(maxtasksperchild=1)
    pending = {p: pool.apply_async(analyse, args=(p, settings, folder),
                                   kwds={'device': str(device)})
               for p in paths}
    pool.close()
    pool.join()
    return pending

def _dispatch_sharded(paths, settings, folder, log, device):
    """Stage 1 for every video at once over the device mesh, then the
    remaining per-file stages serially (see parallel/multi_video.py)."""
    videos = [p for p in paths if '.csv' not in p
              and not any(m in p for m in _FINISHED_MARKERS)]
    staged = track_videos_sharded(videos, settings, folder, device=device) \
        if videos else {}
    outcomes = {}
    for path in paths:
        if path in staged and staged[path] is None:
            outcomes[path] = None  # stage 1 already failed and logged
        else:
            outcomes[path] = analyse(path=path, settings=settings,
                                     result_folder=folder, device=device,
                                     _staged=staged.get(path))
    return outcomes


def _collect_outcomes(pending, multiprocess, log):
    """Resolve results per path; exceptions count as failures, not aborts."""
    finished, failed = [], []
    for path, handle in pending.items():
        try:
            value = handle.get() if multiprocess else handle
        except (FileNotFoundError, PermissionError):
            log.critical('Unreadable or missing: %s', path)
            continue
        except Exception as exc:
            log.critical('%s raised %s:', path, type(exc).__name__)
            for chunk in str(exc.args).splitlines():
                log.critical('%s', chunk)
            log.exception(exc)
            value = None
        if value is None:
            failed.append(path)
            finished.append((path, None))
        else:
            finished.append((path, handle))
    return finished, failed


def ysmr(paths=None, settings=None, result_folder=None, multiprocess=False,
         device='cuda'):
    """Analyse the given videos/CSVs (reference main.py:175-331 capability).

    :param device: 'cuda' (default; raises without a GPU) or 'cpu'
    :return: list of (path, result) tuples, or None on abort
    """
    started = datetime.now()
    device = resolve_device(device)
    settings = get_configs(settings)
    if settings is None:
        print('Fatal error in retrieving tracking.ini')
        return None
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    settings['log file path'] = check_logfile(path=settings['log file path'])

    listener = None if settings['debugging'] else _spawn_log_listener(settings)
    _attach_loggers(settings)
    log = logging.getLogger('ysmr').getChild(__name__)
    banner_filler = log_infos(settings=settings)

    def _teardown():
        stop_logging_queue(log, settings)
        if listener is not None:
            listener.join()

    if settings['debugging']:
        return _debug_fast_path(paths, settings, log, device)

    paths = _resolve_paths(paths, settings, log)
    if paths is None or not _confirm_interactive(settings, log):
        _teardown()
        return None

    if result_folder is None:
        result_folder = create_results_folder(paths[0])
    os.makedirs(result_folder, exist_ok=True)

    try:
        if settings['shard videos across devices'] and len(paths) > 1:
            if multiprocess:
                log.info('Device-mesh video sharding replaces the process '
                         "pool ('shard videos across devices' is set).")
                multiprocess = False
            pending = _dispatch_sharded(paths, settings, result_folder, log,
                                        device)
        elif multiprocess:
            pending = _dispatch_pool(paths, settings, result_folder, log,
                                     device)
        else:
            pending = {p: analyse(path=p, settings=settings,
                                  result_folder=result_folder, device=device)
                       for p in paths}
    except BaseException:
        _teardown()  # the listener process must not outlive a raise
        raise
    finished, failed = _collect_outcomes(pending, multiprocess, log)

    if failed:
        log.critical('%s of %s file(s) did not finish:', len(failed), len(paths))
        for p in failed:
            log.critical('%s', p)
    else:
        log.info('All files processed.')
    if settings['collate results csv to xlsx']:
        collate_results_csv_to_xlsx(path=result_folder, save_path=result_folder)
    if settings['shut down after analysis']:
        shutdown()
    log.info('Batch runtime: %s\n%s\n', elapsed_time(started), banner_filler)
    _teardown()
    return finished


if __name__ == '__main__':
    ysmr()
