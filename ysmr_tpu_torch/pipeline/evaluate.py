# Copied from ysmr_tpu/pipeline/evaluate.py; only the import lines differ.
#!/usr/bin/env python3
"""evaluate_tracks(): per-track statistics, phenotypes, and plots.

Produces the reference's evaluation artifacts (track_eval.py:846-1318):
per-row kinematics with per-track-start resets, px->um conversion, the
motile flag via double median filtering, n-frame displacement angles and
turning points via grouped local extrema, phenotype classification, the
twelve-column statistics frame, the category split for the violin plots,
and the ``_statistics.csv`` / ``_analysed.csv`` files.

PARITY MAP — which block replicates which reference lines, and why the
math there cannot diverge (the column names and the exact float op
sequences ARE the interchange contract: BASELINE.json requires identical
motility statistics, and tests/test_select_eval_parity.py diffs every
value against the live reference):

=======================  ==========================  =======================
this module              reference track_eval.py     parity-load-bearing
=======================  ==========================  =======================
_per_row_kinematics      903-935                     delta resets at track
                                                     starts; um conversion;
                                                     float16 bac_length;
                                                     medfilt kernel pair
_angles_and_turn_points  940-1010                    arctan2(x, y) argument
                                                     order; int32 rounding
                                                     of angles; extrema
                                                     order=10; segment ids
_phenotypes              1013-1026                   1.5 / 5 thresholds
_per_track_stats         1028-1100                   groupby reductions,
                                                     zero-guards, (t+1)/fps
_log_summary             1101-1150                   log text only
_violin_category_split   1152-1214                   bin edge semantics
plots/artifacts (tail)   1216-1318                   CSV schema
=======================  ==========================  =======================

Two reference quirks are replicated deliberately (they shift numbers):

* ``argrelextrema_groupby``'s de-duplication loop iterates
  ``range(-1, -(shift_range+1))`` — an empty range (helper_file.py:59), so no
  de-duplication ever happens; only the ``argrelextrema(>=, order=10)`` mask
  applies.
* the turning-point segment id of the data frame's final row is never
  assigned (the loop at track_eval.py:991-992 writes ``loc[start:stop-1]``),
  leaving it at 0.
"""

import logging
import os
from time import strftime, strptime

import numpy as np
import pandas as pd
from scipy.signal import argrelextrema, medfilt


from ysmr_tpu_torch.config import get_configs
from ysmr_tpu_torch.utils.csv_io import different_tracks, get_data, save_df_to_csv

# the twelve statistics columns, by name (the reference indexes an inline
# list positionally throughout; the names are the _statistics.csv schema)
COL_TURN_POINTS = 'Turn Points (TP/s)'
COL_DISTANCE = 'Distance (µm)'
COL_SPEED = 'Speed (µm/s)'
COL_TIME = 'Time (s)'
COL_DISPLACEMENT = 'Displacement (µm)'
COL_PERC_MOTILE = 'Perc. Motile'
COL_ACR = 'Arc-Chord Ratio'
COL_BAC_LENGTH = 'Bacteria Length'
COL_DISPL_BY_LENGTH = 'Displacement divided by length'
COL_PHENOTYPE = 'Motility Phenotype'
COL_TRACK_ID = 'TRACK_ID'
COL_MEDIAN_SPEED = 'Median Speed'
STAT_COLUMNS = (
    COL_TURN_POINTS, COL_DISTANCE, COL_SPEED, COL_TIME, COL_DISPLACEMENT,
    COL_PERC_MOTILE, COL_ACR, COL_BAC_LENGTH, COL_DISPL_BY_LENGTH,
    COL_PHENOTYPE, COL_TRACK_ID, COL_MEDIAN_SPEED,
)

#: phenotype codes (track_eval.py:1013-1026): 2 motile, 1 twitching,
#: 0 immotile
PHENOTYPES = (0, 1, 2)

#: columns of the final ``_analysed.csv`` (interchange schema)
ANALYSED_COLUMNS = (
    'TRACK_ID', 'POSITION_T', 'POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
    'DEGREES_ANGLE', 'angle_diff', 'moving', 'turn_points', 'tp_of_tracks',
    'travelled_dist', 'motility_phenotype')


def _max_pairwise_distance_per_track(df):
    """Per-track point-set diameter — the value of the reference's
    ``groupby.apply(lambda l: pdist(zip(x, y)).max())`` (track_eval.py:1034)
    without the per-group Python object churn (zip/list/apply cost ~2.2 s at
    4k tracks; this runs in ~0.4 s).

    Equality with pdist().max(): the squared distances use the same
    subtract-square-add float64 ops, and sqrt is monotonic and correctly
    rounded, so ``sqrt(max(d2)) == max(sqrt(d2))`` exactly. For long tracks
    the candidate set is first reduced to its convex hull (the diameter's
    endpoints are hull vertices); degenerate inputs fall back to the full
    set.
    """
    ids = df['TRACK_ID'].to_numpy()
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    stops = np.r_[starts[1:], ids.size]
    x = df['x_norm'].to_numpy(dtype=np.float64)
    y = df['y_norm'].to_numpy(dtype=np.float64)
    out = np.empty(starts.size)
    for k in range(starts.size):
        xs = x[starts[k]:stops[k]]
        ys = y[starts[k]:stops[k]]
        if xs.size > 64:
            try:
                from scipy.spatial import ConvexHull
                v = ConvexHull(np.column_stack([xs, ys])).vertices
                xs, ys = xs[v], ys[v]
            except Exception:  # collinear/degenerate: brute-force the set
                pass
        d2 = np.square(xs[:, None] - xs[None, :]) + \
            np.square(ys[:, None] - ys[None, :])
        out[k] = np.sqrt(d2.max())
    return pd.Series(out, index=pd.Index(ids[starts], name='TRACK_ID'))


def argrelextrema_groupby(group, comparator=np.greater_equal, order=10,
                          shift_range=4, fill_value=0):
    """Grouped local extrema with the reference's (inert) de-dup semantics
    (helper_file.py:39-68)."""
    values = group.to_numpy()
    result = np.zeros(group.shape[0], dtype=np.int8)
    np.put(result, argrelextrema(values, comparator, order=order)[0], 1)
    # reference's shift-based de-duplication loop iterates an empty range and
    # is intentionally not reproduced as active code
    result = np.where(result == 1, values, fill_value)
    return pd.Series(result, index=group.index)


def _plot_title(file_name):
    """Human plot title: strip the ``_selected_data`` suffix, underscores to
    spaces, and a leading yymmddHHMMSS capture stamp rendered as a date
    (reference convention, track_eval.py:430-445)."""
    title = file_name.removesuffix('_selected_data').replace('_', ' ')
    stamp = title[:12]
    if len(stamp) == 12 and stamp.isdigit():
        try:
            pretty = strftime("%d. %m. '%y,", strptime(stamp, '%y%m%d%H%M%S'))
        except ValueError:
            pass
        else:
            title = '{} {}'.format(pretty, title[12:])
    return title


def _per_row_kinematics(df, track_starts, px_to_micrometre, fps, logger):
    """Deltas with track-start resets, track-relative time, sizes in um, and
    the double-median-filtered motile flag (parity: track_eval.py:903-935 —
    the delta resets, the float16 ``bac_length`` narrowing, and the
    3-then-odd-fps medfilt kernel pair all shift downstream numbers).

    Mutates ``df``; returns False when POSITION_T is unusable.
    """
    df['x_delta'] = df['POSITION_X'].diff()
    df['y_delta'] = df['POSITION_Y'].diff()
    df['t_delta'] = df['POSITION_T'].diff()
    df.loc[track_starts, ['x_delta', 'y_delta']] = 0
    df.loc[track_starts, ['t_delta']] = 1
    for item in ('x_delta', 'y_delta', 't_delta'):
        if df[item].isnull().any():
            logger.critical('NaN remained in %s after clean-up at row(s) %s '
                            '(track start rows: %s)', item,
                            np.where(df[item].isnull())[0], track_starts)

    df['t_norm'] = df['POSITION_T'].sub(
        df.groupby('TRACK_ID')['POSITION_T'].transform('first')
    ).astype(np.int32)
    if any(df['t_norm'] < 0):
        return False

    df['WIDTH'] = df['WIDTH'] / px_to_micrometre
    df['HEIGHT'] = df['HEIGHT'] / px_to_micrometre
    df['area'] = df['WIDTH'] * df['HEIGHT']
    df['bac_length'] = np.where(df['WIDTH'] >= df['HEIGHT'], df['WIDTH'],
                                df['HEIGHT']).astype(np.float16)

    df['travelled_dist'] = np.sqrt(np.square(df['x_delta']) +
                                   np.square(df['y_delta'])) / px_to_micrometre
    df['moving'] = df['travelled_dist'] / df['t_delta']
    df['moving'] = np.where(df['moving'] > 10 ** -3, 1, 0).astype(np.int8)
    # second kernel = fps rounded up to odd (medfilt requires odd sizes)
    fps_int = int(round(fps, 0))
    max_kernel = fps_int + 1 if fps_int % 2 == 0 else fps_int
    for kernel_size in (3, max_kernel):
        df['moving'] = df.groupby('TRACK_ID')['moving'].transform(
            medfilt, kernel_size=kernel_size)
    return True


def _angles_and_turn_points(df, track_starts, settings, fps, title,
                            save_path):
    """Displacement angles over n frames, turning points via grouped local
    extrema, per-segment ids and distances, and the displacement ratios the
    phenotype split reads (parity: track_eval.py:940-1010 — the
    ``arctan2(x_diff, y_diff)`` argument order, the int32 truncation of the
    folded angle, the ``order=10`` extrema window, the every-other-start
    segment boundary pick, and the final-row id-0 quirk are all replicated).

    Mutates ``df``.
    """
    angle_diff = settings['compare angle between n frames']
    x_diff_angle = df.groupby('TRACK_ID')['POSITION_X'].diff(angle_diff)
    y_diff_angle = df.groupby('TRACK_ID')['POSITION_Y'].diff(angle_diff)
    df['angle_diff'] = np.arctan2(x_diff_angle, y_diff_angle)  # rad

    if settings['save angle distribution plot / bins']:
        from ysmr_tpu_torch.plot_functions import angle_distribution_plot
        angle_distribution_plot(
            df=df, bins_number=settings['save angle distribution plot / bins'],
            plot_title_name=title,
            save_path=save_path.format('angle_histogram', '.png'))

    # fold the frame-to-frame angle change into [0, 180] and truncate
    min_angle = settings['minimal angle in degrees for turning point']
    df['angle_diff'] = np.degrees(df['angle_diff'])
    df['angle_diff'] = abs(
        df.groupby('TRACK_ID')['angle_diff'].diff().fillna(0))
    df['angle_diff'] = np.where(360 - df['angle_diff'] <= df['angle_diff'],
                                360 - df['angle_diff'],
                                df['angle_diff']).astype(np.int32)
    df['turn_points'] = np.where(
        (df['angle_diff'] > min_angle) & (df['moving'] == 1),
        df['angle_diff'], 0).astype(np.int32)

    # track-relative positions in um (read by the displacement ratios below
    # and by the stats reductions later)
    df['x_norm'] = (df['POSITION_X'].sub(
        df.groupby('TRACK_ID')['POSITION_X'].transform('first'))
    ) / settings['pixel per micrometre']
    df['y_norm'] = (df['POSITION_Y'].sub(
        df.groupby('TRACK_ID')['POSITION_Y'].transform('first'))
    ) / settings['pixel per micrometre']

    df['turn_points'] = df.groupby('TRACK_ID')['turn_points'].transform(
        argrelextrema_groupby)
    df['turn_points'] = np.where(df['turn_points'] == 0, 0, 1).astype(np.int8)
    df.loc[track_starts, ['turn_points']] = 1
    # segment boundaries: every other change point of the 0/1 turn flag,
    # closed with the last row index
    tp_start, _ = different_tracks(df, column='turn_points')
    tp_start = tp_start[::2]
    tp_start.append(int(df.index.max()))
    df['bac_average_size'] = \
        df.groupby('TRACK_ID')['bac_length'].transform('mean')
    # unique id per turning-point segment; the final row keeps id 0 (see
    # module docstring on replicated reference quirks)
    tp_ids = np.zeros(df.shape[0], dtype=np.uint64)
    for i, (start, stop) in enumerate(zip(tp_start[:-1], tp_start[1:])):
        tp_ids[start:stop] = i
    tp_ids[-1] = 0
    df['tp_of_tracks'] = tp_ids
    df['tp_of_tracks'] = np.where(df['moving'] == 0, np.nan,
                                  df['tp_of_tracks'])
    df['tp_dist'] = \
        df.groupby('tp_of_tracks')['travelled_dist'].transform('sum')

    # displacement over a ~10 s window (clamped to half the track-length
    # bounds), normalized by mean size — feeds the phenotype thresholds
    window_candidates = [10.0]
    for key in ('minimal length in seconds', 'limit track length to x seconds'):
        half = settings[key] / 2
        if 0 < half < 10:
            window_candidates.append(half)
    seconds_difference = min(window_candidates)
    shift = int(round(fps * seconds_difference, 0))
    df['x_fps_diff'] = df.groupby('TRACK_ID')['x_norm'].diff(shift)
    df['y_fps_diff'] = df.groupby('TRACK_ID')['y_norm'].diff(shift)
    df['pdist_series_max'] = np.sqrt(np.square(df['x_fps_diff']) +
                                     np.square(df['y_fps_diff']))
    df['pdist_series_max'] = \
        df.groupby('TRACK_ID')['pdist_series_max'].transform('max')
    df['pdist_series_max'] = df['pdist_series_max'] / df['bac_average_size']
    df['tp_dist_by_size_max'] = \
        df.groupby('TRACK_ID')['tp_dist'].transform('max') / \
        df['bac_average_size']


def _phenotypes(df):
    """Phenotype per row: 2 motile, 1 twitching, 0 immotile (parity:
    track_eval.py:1013-1026 — the 1.5x-size displacement and 5x-size
    turning-segment-distance thresholds; NaN ratios compare False and land
    on immotile, as in the reference)."""
    df['motility_phenotype'] = np.select(
        [(df['pdist_series_max'] > 1.5) & (df['tp_dist_by_size_max'] > 5),
         (df['pdist_series_max'] > 1.5)],
        [np.int8(2), np.int8(1)], default=np.int8(0)).astype(np.int8)


def _per_track_stats(df, track_starts, fps):
    """The twelve-column per-track statistics frame (parity:
    track_eval.py:1028-1100 — every reduction, zero-guard, and the
    ``(t_norm_last + 1) / fps`` duration convention).

    Also re-derives ``turn_points`` without immotile tracks (segment counts
    feed TP/s) — mutates ``df``.
    """
    pdist_series = _max_pairwise_distance_per_track(df)
    time_series = df.groupby('TRACK_ID')['t_norm'].agg('last')
    median_speed = pd.Series(
        df.groupby(['TRACK_ID', df.index // fps])['travelled_dist'].sum()
        .groupby(level=0).median(),
        index=time_series.index)
    motile_total_series = df.groupby('TRACK_ID')['moving'].agg('sum')
    motile_series = motile_total_series / (time_series + 1) * 100
    time_series = (time_series + 1) / fps
    dist_series = df.groupby('TRACK_ID')['travelled_dist'].agg('sum')
    acr_series = np.sqrt(
        np.square(df.groupby('TRACK_ID')['x_norm'].agg('last')) +
        np.square(df.groupby('TRACK_ID')['y_norm'].agg('last')))
    speed_series = pd.Series(
        np.where(motile_total_series != 0, dist_series / time_series, 0),
        index=time_series.index)
    acr_series = pd.Series(
        np.where(dist_series != 0, acr_series / dist_series, 0),
        index=time_series.index)

    # remove turning points from immotile tracks; re-seed track starts
    df['turn_points'] = np.where(df['motility_phenotype'] != 0,
                                 df['turn_points'], 0)
    df.loc[track_starts, ['turn_points']] = 1

    turn_per_s_series = \
        (df.groupby('TRACK_ID')['turn_points'].agg('sum') - 1) * fps
    turn_per_s_series = pd.Series(
        np.where(motile_total_series != 0,
                 turn_per_s_series / motile_total_series, 0),
        index=time_series.index)

    bac_length_series = pd.Series(
        df.groupby('TRACK_ID')['bac_length'].agg('mean'))
    displ_bac_series = pd.Series(
        np.where(bac_length_series != 0, pdist_series / bac_length_series, 0),
        index=time_series.index)
    track_id = df.groupby('TRACK_ID')['TRACK_ID'].agg('last')
    mot_phenotype = df.groupby('TRACK_ID')['motility_phenotype'].agg('last')

    return pd.concat([
        turn_per_s_series, dist_series, speed_series, time_series,
        pdist_series, motile_series, acr_series, bac_length_series,
        displ_bac_series, mot_phenotype, track_id, median_speed,
    ], keys=list(STAT_COLUMNS), axis=1)


def _log_summary(df_stats, logger):
    """Phenotype fractions and track-duration quantiles (observability
    parity with track_eval.py:1101-1150)."""
    pheno = df_stats[COL_PHENOTYPE]
    fractions = [pheno.where(pheno == code).count() / df_stats.shape[0]
                 for code in PHENOTYPES]
    logger.info('Nonmotile: %.2f%%, twitching: %.2f%%, motile: %.2f%%',
                *(100 * f for f in fractions))
    durations = df_stats[COL_TIME]
    quantiles = np.quantile(durations, (0.25, 0.5, 0.75))
    logger.debug('Time duration of selected tracks min: %.3f, max: %.3f, '
                 'Quantiles (25/50/75%%): %.3f, %.3f, %.3f',
                 min(durations), max(durations), *quantiles)


def _violin_category_split(df_stats, settings, logger):
    """Duplicate the stats rows into an 'All' band plus the configured value
    bands for the violin plots (parity: track_eval.py:1152-1214 — the
    half-open ``low <= x < high`` bins, the phenotype pseudo-bins at
    ``[n, n+0.001)``, rows outside every band dropped from the banded copy
    only, and the category-major display order).

    :return: (stacked frame, category column name, cut_off_list)
    """
    requested = settings['split results by (Turn Points / Distance / Speed / '
                         'Time / Displacement / perc. motile)']
    split_on = next((name for name in STAT_COLUMNS
                     if requested.lower() in name.lower()), None)
    if split_on is None:
        logger.warning("'split results by parameter' could not be assigned, "
                       "reverted to 'perc. motile'.")
        split_on = COL_PERC_MOTILE

    edges = settings['split violin plots on']
    if split_on == COL_PHENOTYPE:
        bands = [(0, 0.001, 'Immotile'), (1, 1.001, 'Twitching'),
                 (2, 2.001, 'Motile')]
    else:
        label = '{:.1f}% - {:.1f}%' if split_on == COL_PERC_MOTILE \
            else '{:.2f} - {:.2f}'
        bands = [(a, b, label.format(a, b))
                 for a, b in zip(edges[:-1], edges[1:])]
    name_all = 'All'
    cut_off_list = [(-np.inf, np.inf, name_all)] + bands

    category_col = 'Categories ({})'.format(split_on)
    df_stats[category_col] = name_all
    banded = df_stats.copy()
    banded[category_col] = np.nan
    values = df_stats[split_on]
    for band_i, (low, high, _) in enumerate(cut_off_list):
        if band_i == 0:
            continue  # the 'All' band is the un-banded original frame
        banded[category_col] = np.where((low <= values) & (high > values),
                                        band_i, banded[category_col])
    banded.dropna(subset=[category_col], inplace=True)
    band_names = [name for (_, _, name) in cut_off_list]
    banded[category_col] = banded[category_col].replace(
        dict(zip(range(1, len(cut_off_list)), band_names[1:])))
    stacked = pd.concat([df_stats, banded], ignore_index=True)
    display_rank = {name: i for i, name in enumerate(band_names)}
    stacked = stacked.iloc[
        stacked[category_col].map(display_rank).sort_values().index]
    return stacked, category_col, cut_off_list


#: (stats column, file suffix, settings stem) per optional violin plot;
#: the y-limits come from '<stem> min'/'<stem> max'
_VIOLIN_PLOTS = (
    (COL_TURN_POINTS, 'turning_points', 'turning point violin plot'),
    (COL_DISTANCE, 'distance', 'length violin plot'),
    (COL_SPEED, 'speed', 'speed violin plot'),
    (COL_TIME, 'time_plot', 'time violin plot'),
    (COL_DISPLACEMENT, 'displacement', 'displacement violin plot'),
    (COL_PERC_MOTILE, 'perc_motile', 'percent motile plot'),
    (COL_ACR, 'arc-chord_ratio', 'acr violin plot'),
)


def _render_plots(df, df_stats, stacked, category_col, cut_off_list,
                  settings, title, save_path):
    """Large overview / rose / violin figures (track_eval.py:1216-1280)."""
    if settings['save large plots'] or settings['save rose plot']:
        from ysmr_tpu_torch.plot_functions import large_xy_plot, rose_graph
        distance_min = df_stats[COL_DISTANCE].min()
        distance_max = df_stats[COL_DISTANCE].max()
        df['distance_colour'] = df.groupby('TRACK_ID')['travelled_dist'] \
            .transform('sum') - distance_min
        df['distance_colour'] = \
            df['distance_colour'] / df['distance_colour'].max()
        if settings['save large plots']:
            large_xy_plot(df=df, plot_title_name=title,
                          save_path=save_path.format('Bac_Run_Overview',
                                                     '.png'),
                          dist_min=distance_min, dist_max=distance_max,
                          px_to_micrometre=settings['pixel per micrometre'])
        if settings['save rose plot']:
            rose_graph(df=df, plot_title_name=title,
                       save_path=save_path.format('rose_graph', '.png'),
                       dist_min=distance_min, dist_max=distance_max)

    from ysmr_tpu_torch.plot_functions import violin_plot
    selected = [(column, suffix, settings['{} min'.format(stem)],
                 settings['{} max'.format(stem)])
                for column, suffix, stem in _VIOLIN_PLOTS
                if settings['save {}'.format(stem)]]
    selected.append((COL_MEDIAN_SPEED, 'Median_speed', None, None))
    for column, suffix, y_min, y_max in selected:
        violin_plot(df=stacked, save_path=save_path.format(suffix, '.png'),
                    cut_off_category=category_col, category=column,
                    cut_off_list=cut_off_list, verbose=settings['verbose'],
                    y_min=y_min, y_max=y_max, plot_title_name=title)


def evaluate_tracks(path_to_file, results_directory, df=None, settings=None,
                    fps=None, **_):
    """Calculate per-track statistics from a selected-tracks frame.

    :return: (analysed df, statistics df) or None
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        logger.critical('Settings missing; cannot evaluate.')
        return None
    if fps is None or fps <= 0 or settings['force tracking.ini fps settings']:
        if settings['frames per second'] > 0:
            fps = settings['frames per second']
        else:
            logger.critical('Unusable fps value (<= 0); aborting evaluation.')
            return None
    file_name = os.path.splitext(os.path.basename(path_to_file))[0]
    if not isinstance(df, pd.DataFrame):
        if settings['verbose']:
            logger.debug('Loading selected tracks from %s', path_to_file)
        df = get_data(path_to_file)
    if df is None:
        logger.critical('Selected-track table could not be read: %s',
                        path_to_file)
        return None
    track_starts, _ = different_tracks(df)
    title = _plot_title(file_name)
    save_path = os.path.join(results_directory, file_name) + '_{}{}'

    if settings['verbose']:
        logger.debug('Computing per-row deltas and travelled distance')
    if not _per_row_kinematics(df, track_starts,
                               settings['pixel per micrometre'], fps, logger):
        logger.critical('Negative POSITION_T values; cannot evaluate %s',
                        path_to_file)
        return None
    _angles_and_turn_points(df, track_starts, settings, fps, title, save_path)
    _phenotypes(df)

    if settings['verbose']:
        logger.debug('Computing the per-track statistics table')
    df_stats = _per_track_stats(df, track_starts, fps)
    if settings['store generated statistical .csv file']:
        save_df_to_csv(df=df_stats,
                       save_path=save_path.format('statistics', '.csv'))
    _log_summary(df_stats, logger)

    stacked, category_col, cut_off_list = \
        _violin_category_split(df_stats, settings, logger)
    _render_plots(df, df_stats, stacked, category_col, cut_off_list,
                  settings, title, save_path)

    df = df.loc[:, list(ANALYSED_COLUMNS)]
    if settings['store final analysed .csv file']:
        save_df_to_csv(df=df, save_path=save_path.format('analysed', '.csv'))

    logging.info('Done evaluating file %s', file_name)
    return df, df_stats
