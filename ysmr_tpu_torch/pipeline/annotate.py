# Copied from ysmr_tpu/pipeline/annotate.py; only the import lines differ.
#!/usr/bin/env python3
"""annotate_video(): burn track ids/centroids/state colours into the clip.

Capability parity with the reference (track_eval.py:1321-1472): re-reads the
source video, marks every tracked object per frame — id label plus centroid
dot, coloured by state (green = motile, orange = immotile, white = turning
point) — optionally restricted to one motility phenotype, and either writes
a codec-configurable output video or plays it live.

Unlike the reference's per-row pandas iteration, the overlay is compiled
once up front into flat numpy draw tables (ints, colour indices, frame
offsets via searchsorted); the frame loop then only slices arrays and issues
cv2 draw calls. Drawing and encoding stay on the host by design.
"""

import logging
import os
from time import sleep

import cv2
import numpy as np
import pandas as pd

from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.utils.csv_io import get_data
from ysmr_tpu_torch.utils.files import create_results_folder
from ysmr_tpu_torch.utils.logging_utils import get_loggers

PHENOTYPES = ('immotile', 'twitching', 'motile')

# state -> (BGR colour, centroid radius, label line thickness)
_STATE_STYLE = (
    ((0, 255, 0), 0, 0),       # 0: motile (moving, not turning)
    ((15, 165, 253), 0, 0),    # 1: immotile
    ((255, 255, 255), 1, 1),   # 2: turn point
)

_ANNOTATE_DTYPES = {
    'TRACK_ID': np.int64,
    'POSITION_T': np.int64,
    'POSITION_X': np.float64,
    'POSITION_Y': np.float64,
    'motility_phenotype': object,
    'moving': np.int8,
    'turn_points': np.int8,
}


def _compile_overlays(df, select_subtype):
    """Flatten the analysed df into per-frame draw tables.

    :return: dict with sorted frame numbers and parallel arrays
        (x, y, id text, state index) plus searchsorted frame offsets,
        or None when nothing is left to draw.
    """
    if select_subtype is not None:
        df = df[df['motility_phenotype'] == select_subtype]
    if not len(df):
        return None
    order = np.argsort(df['POSITION_T'].to_numpy(), kind='stable')
    t = df['POSITION_T'].to_numpy()[order]
    state = np.where(df['moving'].to_numpy()[order] == 0, 1,
                     np.where(df['turn_points'].to_numpy()[order] == 1, 2, 0))
    return {
        't': t,
        'x': df['POSITION_X'].to_numpy()[order].astype(np.int64),
        'y': df['POSITION_Y'].to_numpy()[order].astype(np.int64),
        'label': df['TRACK_ID'].to_numpy()[order].astype(np.int64),
        'state': state,
    }


def _draw_frame(frame, tables, lo, hi):
    """Issue the cv2 draw calls for rows [lo, hi) of the overlay tables."""
    x, y = tables['x'], tables['y']
    labels, states = tables['label'], tables['state']
    for i in range(lo, hi):
        colour, radius, thickness = _STATE_STYLE[states[i]]
        cv2.putText(frame, str(labels[i]), (int(x[i]) - 10, int(y[i]) - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.3, colour, thickness)
        cv2.circle(frame, (int(x[i]), int(y[i])), radius, colour, -1)


def _output_name(result_folder, video_path, extension, select_subtype):
    stem = os.path.splitext(os.path.basename(video_path))[0]
    if select_subtype is None:
        name = '{}_annotated_output{}'.format(stem, extension)
    else:
        name = '{}_subtype_{}_annotated_output{}'.format(
            select_subtype, stem, extension)
    return os.path.join(result_folder, name)


def _can_display():
    return bool(os.environ.get('DISPLAY') or os.environ.get('WAYLAND_DISPLAY'))


def annotate_video(video_path, df, output_save=True, settings=None,
                   result_folder=None, select_subtype=None, **_):
    """Annotate ``video_path`` with positions/state from the analysed ``df``.

    :param select_subtype: optional phenotype filter — an index into or a
        name from ``PHENOTYPES``
    :return: None
    """
    log = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        return None
    get_loggers(log_level=settings['log_level'],
                logfile_name=settings['log file path'],
                short_stream_output=settings['shorten displayed logging output'],
                short_file_output=settings['shorten logfile logging output'],
                log_to_file=settings['log to file'])
    if isinstance(select_subtype, int):
        select_subtype = PHENOTYPES[select_subtype]

    if not isinstance(df, pd.DataFrame):
        if settings['verbose']:
            log.debug('annotate_video loading csv: %s', df)
        df = get_data(df, dtype=_ANNOTATE_DTYPES)
        if df is None:
            return None
    tables = _compile_overlays(df, select_subtype)
    if tables is None:
        log.warning('No rows to annotate for %s (subtype filter: %s).',
                    video_path, select_subtype)
        return None

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        log.exception('Cannot open file %s', video_path)
        return None
    result_folder = result_folder or create_results_folder(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    dims = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    fps = cap.get(cv2.CAP_PROP_FPS)
    if not fps or fps <= 0:
        fps = settings['frames per second']
        if fps <= 0:
            log.critical('No usable fps (file reports none, setting is %s)',
                         fps)
            cap.release()
            return None

    if not output_save and not _can_display():
        log.warning('Live annotation requested but no display is available '
                    '(DISPLAY unset); writing the video instead.')
        output_save = True
    out_path = _output_name(result_folder, video_path,
                            settings['save video file extension'],
                            select_subtype)
    writer = None
    if output_save:
        fourcc = cv2.VideoWriter_fourcc(*settings['save video fourcc codec'])
        writer = cv2.VideoWriter(out_path, fourcc, fps, dims)
    window = os.path.splitext(os.path.basename(video_path))[0] if \
        select_subtype is None else '{} {}'.format(
            os.path.splitext(os.path.basename(video_path))[0], select_subtype)

    frame_no = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            # clean EOF when the header count agrees (+-1) and the clip is
            # long enough; anything else is a decode error
            at_end = total in (frame_no, frame_no + 1)
            if at_end and total >= settings['minimal frame count']:
                log.debug('All frames of %s annotated.',
                          os.path.basename(video_path))
            else:
                log.critical('Decode error at frame %s of %s', frame_no,
                             video_path)
            break
        lo = np.searchsorted(tables['t'], frame_no, side='left')
        hi = np.searchsorted(tables['t'], frame_no, side='right')
        _draw_frame(frame, tables, lo, hi)
        if writer is not None:
            writer.write(frame)
        else:
            sleep(1 / fps)
            cv2.putText(frame, '{:>6}'.format(frame_no), (20, 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (220, 220, 60), 1)
            cv2.imshow(window, frame)
            if cv2.waitKey(1) & 0xFF == ord('q'):
                log.error('Annotation preview of %s stopped by user.',
                          video_path)
                break
        frame_no += 1

    if writer is not None:
        writer.release()
        log.debug('Annotated video written to %s', out_path)
    else:
        cv2.destroyAllWindows()
    cap.release()
    return None
