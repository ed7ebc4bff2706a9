# Copied from ysmr_tpu/pipeline/select.py; only the import lines differ.
#!/usr/bin/env python3
"""select_tracks(): good-track selection with reference-exact semantics.

Mirrors the reference's selection stage (track_eval.py:408-843): vectorised
NaN-marking of suspect measurements, quantile/IQR outlier fences, then the
per-track acceptance gauntlet with its nine "kick reasons". The reference's
recursive ``find_good_tracks`` (track_eval.py:408-536) — which splits tracks
at holes/outliers and re-evaluates the halves — is re-expressed as an
explicit depth-first worklist with the same visit order, result order, and
recursion-depth cap, so it cannot overflow the stack and vectorises the
per-segment reductions over numpy slices.

This stage runs on host (pandas/numpy): it is not the throughput bottleneck
(one pass over the track table vs. per-pixel work on device) and the
reference's pandas semantics (quantile interpolation, first-occurrence
idxmax, NaN-skipping) are preserved exactly.
"""

import logging
import os

import numpy as np
import pandas as pd

from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.utils.csv_io import different_tracks, get_data, save_df_to_csv
from ysmr_tpu_torch.utils.files import create_results_folder

'''
# kick_reason ladder (track_eval.py:439-450):
8: size < minimal length
7: holes > maximal consecutive holes (split and retried)
6: distance outlier (split and retried)
5: duration/size ratio over bound
4: average area not within bounds
3: average w/h ratio not within bounds
2: average x/y not within screen-edge band
1: min/max xy outside frame
0: pass
'''


def _segment_checks(t, area, ratio, x, y, dist_flag, start, stop, *,
                    lower_boundary, upper_boundary, frame_height, frame_width,
                    settings, minimal_length_frames):
    """One gauntlet evaluation of [start, stop]; returns
    (kick_reason, passed, split) where split is None or (part_a, part_b)."""
    size = stop - start + 1
    kick = 8
    if size < minimal_length_frames:
        return kick, False, None
    kick = 7
    tt = t[start:stop + 1]
    holes = np.diff(tt.astype(np.int64))
    if holes.size and holes.max() > settings['maximal consecutive holes']:
        # split at the first largest hole; hole index belongs to second part
        idx_hole = start + 1 + int(np.argmax(holes))
        return kick, False, ((start, idx_hole - 1), (idx_hole, stop))
    kick = 6
    dflag = dist_flag[start:stop + 1]
    if dflag.sum() != 0:
        idx_outlier = start + int(np.argmax(dflag))
        return kick, False, ((start, idx_outlier - 1), (idx_outlier + 1, stop))
    kick = 5
    duration = tt[-1] - tt[0] + 1
    if duration / size >= settings['maximal empty frames in %']:
        return kick, False, None
    kick = 4
    a_mean = area[start:stop + 1].mean()
    if not (lower_boundary <= a_mean <= upper_boundary):
        return kick, False, None
    kick = 3
    r_mean = ratio[start:stop + 1].mean()
    if not (settings['average width/height ratio min.'] < r_mean
            < settings['average width/height ratio max.']):
        return kick, False, None
    kick = 2
    edge = settings['percent of screen edges to exclude']
    y_mean = y[start:stop + 1].mean()
    x_mean = x[start:stop + 1].mean()
    if not (edge * frame_height < y_mean < (1 - edge) * frame_height and
            edge * frame_width < x_mean < (1 - edge) * frame_width):
        return kick, False, None
    kick = 1
    xs = x[start:stop + 1]
    ys = y[start:stop + 1]
    if edge != 0 and (xs.min() < 0 or xs.max() > frame_width or
                      ys.min() < 0 or ys.max() > frame_height):
        return kick, False, None
    return 0, True, None


def find_good_tracks_worklist(arrays, start, stop, *, lower_boundary,
                              upper_boundary, frame_height, frame_width,
                              settings, minimal_length_frames):
    """Depth-first worklist with the recursion semantics of
    track_eval.py:408-536; returns (list of passing (start, stop), kick)."""
    t, area, ratio, x, y, dist_flag = arrays
    max_depth = settings['maximal recursion depth']
    results = []
    kick_reasons = []
    stack = [(start, stop, 0)]
    while stack:
        s, e, depth = stack.pop()
        kick, passed, split = _segment_checks(
            t, area, ratio, x, y, dist_flag, s, e,
            lower_boundary=lower_boundary, upper_boundary=upper_boundary,
            frame_height=frame_height, frame_width=frame_width,
            settings=settings, minimal_length_frames=minimal_length_frames)
        kick_reasons.append(kick)
        if passed:
            results.append((s, e))
            continue
        if split is not None and depth < max_depth:
            # push in reverse so the first half is evaluated first (DFS order
            # of the reference's recursion, which fixes tie-breaking of the
            # longest-fragment choice)
            for sub_s, sub_e in reversed(split):
                sub_size = sub_e - sub_s + 1
                if minimal_length_frames < 3:
                    if sub_size < 3:
                        continue
                elif sub_size < minimal_length_frames:
                    continue
                stack.append((sub_s, sub_e, depth + 1))
    return results, min(kick_reasons)


def select_tracks(path_to_file=None, df=None, results_directory=None, fps=None,
                  frame_height=None, frame_width=None, settings=None, **_):
    """Select good tracks from file or data frame (track_eval.py:539-843).

    :return: selected DataFrame or None
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        logger.critical('No settings provided / could not get settings.')
        return None
    if settings['verbose']:
        logger.debug('Selecting tracks for %s', path_to_file)
    if path_to_file is None:
        path_to_file = settings.get('path to test .csv', None)
    if results_directory is None:
        results_directory = create_results_folder(path_to_file)
    file_name = os.path.splitext(os.path.basename(path_to_file))[0]

    if fps is None or fps <= 0 or settings['force tracking.ini fps settings']:
        if settings['frames per second'] > 0:
            fps = settings['frames per second']
        else:
            logger.critical('Unusable fps value (<= 0); aborting selection.')
            return None
    minimal_length_frames = int(round(fps, 0) * settings['minimal length in seconds'])
    limit_track_to_frames = int(round(fps, 0) * settings['limit track length to x seconds'])
    if settings['extreme area outliers lower end in px*px'] >= \
            settings['extreme area outliers upper end in px*px']:
        logger.critical(
            'Area outlier bounds are inverted (lower >= upper) — no track '
            'can pass. Fix tracking.ini. Lower: %s, upper: %s',
            settings['extreme area outliers lower end in px*px'],
            settings['extreme area outliers upper end in px*px'])
        return None
    if frame_width is None or frame_height is None:
        logger.debug('Frame dimensions not passed in; using tracking.ini values.')
        frame_width = settings['frame width']
        frame_height = settings['frame height']
    if frame_height <= 0 or frame_width <= 0:
        logger.critical('Frame width or height 0 or negative. Width: %s, height: %s',
                        frame_width, frame_height)
        return None
    if settings['pixel per micrometre'] <= 0:
        logger.critical("'pixel per micrometre' zero or negative: %s",
                        settings['pixel per micrometre'])
        return None
    if not isinstance(df, pd.DataFrame):
        if settings['verbose']:
            logger.debug('Loading track table from %s', path_to_file)
        df = get_data(path_to_file)
    if df is None:
        logger.critical('Track table could not be read: %s', path_to_file)
        return None
    if df.shape[0] < minimal_length_frames:
        logger.critical(
            'Too few rows before initial clean-up (need %s frames, have '
            '%s): %s',
            minimal_length_frames, df.shape[0], path_to_file)
        return None

    _, track_change = different_tracks(df)
    initial_length, initial_size = len(track_change), df.shape[0]

    # --- vectorised NaN marking (track_eval.py:626-674) ---
    df['area'] = df['WIDTH'] * df['HEIGHT']
    if settings['verbose']:
        logger.debug('Marking excluded measurements as NaN')
    df['average_area'] = df.groupby('TRACK_ID')['area'].transform('median')
    df['area'] = np.where(
        (df['average_area'] >= settings['extreme area outliers lower end in px*px']) &
        (df['average_area'] <= settings['extreme area outliers upper end in px*px']),
        df['area'], np.nan)
    if settings['exclude measurement when above x times average area']:
        df['area'] = np.where(
            df['area'] <= (df['average_area'] *
                           settings['exclude measurement when above x times average area']),
            df['area'], np.nan)
    # tracker emits zeroed side info while an object is disappeared; those
    # rows carry area == 0 and are suspect (track_eval.py:646-649)
    df.loc[df['area'] == 0, 'area'] = np.nan
    df['length'] = (df.groupby('TRACK_ID')['POSITION_T'].transform('last') -
                    df.groupby('TRACK_ID')['POSITION_T'].transform('first') + 1
                    ).astype(np.uint16)
    df['area'] = np.where(df['length'] >= minimal_length_frames, df['area'], np.nan)

    if settings['verbose']:
        logger.debug('Dropping NaN-marked rows')
    df.dropna(inplace=True, subset=['area'])
    df.reset_index(drop=True, inplace=True)
    if df.shape[0] < minimal_length_frames:
        logger.warning(
            'Too few rows left after initial clean-up (need %s, have %s): '
            '%s',
            minimal_length_frames, df.shape[0], path_to_file)
        return None
    track_start, track_change = different_tracks(df)
    logger.info(
        'Tracks before initial cleanup: %s, after: %s, loss: %.4f%%, data frame '
        'entries before: %s, after: %s, loss: %.4f%%',
        initial_length, len(track_change),
        100.0 * (initial_length - len(track_change)) / initial_length,
        initial_size, df.shape[0],
        100.0 * (initial_size - df.shape[0]) / initial_size)

    df['ratio_wh'] = np.where(df['HEIGHT'] <= df['WIDTH'],
                              df['HEIGHT'] / df['WIDTH'],
                              df['WIDTH'] / df['HEIGHT'])

    # area quantile fences (track_eval.py:703-712)
    if settings['percent quantiles excluded area'] > 0:
        q1_area, q3_area = df['area'].quantile(q=[
            settings['percent quantiles excluded area'],
            1 - settings['percent quantiles excluded area']])
        logger.info('Area quartiles: 10%%: %.2f, 90%%: %.2f', q1_area, q3_area)
    else:
        q1_area, q3_area = -1, np.inf

    # motility-outlier IQR outer fence (track_eval.py:713-739)
    if settings['try to omit motility outliers']:
        df['distance'] = np.sqrt(np.square(df['POSITION_X'].diff()) +
                                 np.square(df['POSITION_Y'].diff())) / \
            df['POSITION_T'].diff()
        df.loc[track_start, ['distance']] = 0
        q1_dist, q3_dist = df['distance'].quantile(q=[0.25, 0.75])
        distance_outlier = (q3_dist - q1_dist) * 3 + q3_dist
        df['distance'] = np.where(df['distance'] > distance_outlier, 1, 0
                                  ).astype(np.int8)
        outlier_percents = df['distance'].sum() / df.shape[0]
        logger.info('25/75 %% Distance quartiles: %.3f, %.3f upper outliers: %.3f '
                    'counts: %s, of all entries: %.4f%%', q1_dist, q3_dist,
                    distance_outlier, df['distance'].sum(), 100 * outlier_percents)
        if outlier_percents > \
                settings['stop excluding motility outliers if total count above percent']:
            logger.warning(
                'Motility outliers more than %.2f%% of all data points (%.2f%%); '
                'recommend to re-analyse with outlier removal changed if upper '
                'quartile is especially low (Quartile: %.3f)',
                100 * settings['stop excluding motility outliers if total count '
                               'above percent'],
                100 * outlier_percents, q3_dist)
            logger.info('Disabling distance-outlier exclusion: outlier share '
                        'too high')
            df['distance'] = np.zeros(df.shape[0], dtype=np.int8)
    else:
        df['distance'] = np.zeros(df.shape[0], dtype=np.int8)

    if settings['verbose']:
        logger.debug('Running the per-track selection gauntlet')

    arrays = (df['POSITION_T'].to_numpy(), df['area'].to_numpy(),
              df['ratio_wh'].to_numpy(), df['POSITION_X'].to_numpy(),
              df['POSITION_Y'].to_numpy(), df['distance'].to_numpy())
    t_arr = arrays[0]

    kick_reasons = [0] * 9
    good_track = []
    for start, stop in zip(track_start, track_change):
        good_track_result, kick_reason = find_good_tracks_worklist(
            arrays, start, stop, lower_boundary=q1_area, upper_boundary=q3_area,
            frame_height=frame_height, frame_width=frame_width, settings=settings,
            minimal_length_frames=minimal_length_frames)
        kick_reasons[kick_reason] += 1
        if not good_track_result:
            continue
        # longest passing fragment, first on ties (track_eval.py:769-777)
        good_selection = 0
        if len(good_track_result) > 1:
            good_comparator = 0
            for idx_good, (gs, ge) in enumerate(good_track_result):
                curr_length = ge - gs + 1
                if curr_length > good_comparator:
                    good_selection = idx_good
                    good_comparator = curr_length
        good_start, good_stop = good_track_result[good_selection]
        # truncate to the track-length limit (track_eval.py:779-792)
        if limit_track_to_frames:
            limit_curr = limit_track_to_frames + t_arr[good_start] - 1
            seg = t_arr[good_start:good_stop + 1]
            if not settings['limit track length exactly']:
                candidates = np.nonzero(seg <= limit_curr)[0]
            else:
                candidates = np.nonzero(seg == limit_curr)[0]
            if candidates.size == 0:
                continue
            # idxmax over equal values returns the first occurrence of the
            # maximum POSITION_T among candidates; T is increasing per track,
            # so that is the last candidate
            good_stop = good_start + int(candidates[np.argmax(seg[candidates])])
        good_track.append((int(good_start), int(good_stop)))

    logger.info('All tracks before fine selection: %s, left over: %s, difference: %s',
                len(track_change), len(good_track),
                len(track_change) - len(good_track))
    kick_string = ('Gauntlet tally — total: {9}, passed: {0}; rejected for '
                   'off-screen min/max xy: {1}, average xy near edge: {2}, '
                   'bad w/h ratio: {3}, area bounds: {4}, duration vs size: '
                   '{5}, distance outliers: {6}, hole count: {7}, '
                   'short size: {8}').format(*kick_reasons,
                                             sum(kick_reasons))
    if kick_reasons[0] < 1000 and kick_reasons[0] / max(sum(kick_reasons), 1) < 0.3:
        logger.warning('Few tracks passed selection')
        logger.warning(kick_string)
    else:
        logger.info(kick_string)

    if not good_track:
        logger.warning('File %s has no acceptable tracks.', path_to_file)
        return None

    good_mask = np.zeros(df.shape[0], dtype=np.int8)
    for (start, stop) in good_track:
        good_mask[start:stop + 1] = 1
    df['good_track'] = good_mask

    if settings['verbose']:
        logger.debug('Resetting df')
    df_passed_columns = ['TRACK_ID', 'POSITION_T', 'POSITION_X', 'POSITION_Y',
                         'WIDTH', 'HEIGHT', 'DEGREES_ANGLE']
    df = df.loc[df['good_track'] == 1, df_passed_columns]
    df.reset_index(inplace=True)
    save_path = os.path.join(results_directory, file_name) + '_{}{}'
    if settings['store processed .csv file']:
        save_df_to_csv(df=df, save_path=save_path.format('selected_data', '.csv'))
    return df
