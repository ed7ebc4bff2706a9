# Copied from ysmr_tpu/plot_functions.py; matplotlib is imported at first use.
#!/usr/bin/env python3
"""Plot outputs: polar angle histogram, XY overview, rose plot, violin plots.

Capability parity with the reference's plot_functions.py (:29-370): the same
four figure types, file naming, A4-landscape sizing, viridis-reversed
distance colouring with a µm colour bar, and per-violin summary text.
Implementation is shared-core: both track-overview figures (raw XY and
re-origined rose) run through one scatter routine, and the colour bar is a
standard ``fig.colorbar`` on a ScalarMappable rather than a dedicated
gridspec column. Written against current matplotlib/seaborn APIs.

matplotlib (and seaborn for the violins) is imported inside the functions,
so the package imports on a host without it; a plot there raises
ImportError.
"""

import logging

import numpy as np

__all__ = ['angle_distribution_plot', 'large_xy_plot', 'rose_graph', 'violin_plot']

_A4_LANDSCAPE = (11.6929133858, 8.2677165354)  # inches
_MOTILITY_FLOOR = 0.7  # tracks below 70 % average motility are excluded


def _log():
    return logging.getLogger('ysmr').getChild(__name__)


def _pyplot():
    """(matplotlib, pyplot) on the headless Agg backend; annotate and the
    live display draw with cv2."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return matplotlib, plt


def _finish(fig, save_path, dpi, verbose=True):
    fig.savefig(save_path, dpi=dpi)
    if verbose:
        _log().debug('Figure written: %s', save_path)
    _pyplot()[1].close(fig)


def angle_distribution_plot(df, bins_number, plot_title_name, save_path, dpi=300):
    """Polar histogram of n-frame displacement angles, motile tracks only.

    A data point contributes when its own ``moving`` flag is set AND its
    track's average motility exceeds 70 % (reference plot_functions.py:29-90).
    """
    track_motility = df.groupby('TRACK_ID')['moving'].transform('mean')
    contributes = df['moving'].astype(bool) & \
        (track_motility.to_numpy() > _MOTILITY_FLOOR)
    n_points = int(contributes.sum())
    if not n_points:
        _log().warning('Angle distribution plot skipped: no track passes the '
                       '%d%% motility floor.', int(_MOTILITY_FLOOR * 100))
        return
    edges = np.linspace(-np.pi, np.pi, bins_number + 1)
    counts = np.histogram(df.loc[np.asarray(contributes), 'angle_diff'],
                          edges)[0]

    fig = _pyplot()[1].figure(figsize=_A4_LANDSCAPE)
    ax = fig.add_subplot(projection='polar')
    ax.set_theta_zero_location('N')
    ax.set_theta_direction(-1)
    ax.bar(edges[:-1], counts, width=2 * np.pi / bins_number, bottom=0.0,
           edgecolor='k', alpha=0.5)
    ax.set_title('{} Data points: {}'.format(plot_title_name, n_points))
    _finish(fig, save_path, dpi)


def _track_overview(df, x_col, y_col, title, save_path, *, scale=1.0,
                    dist_min=0, dist_max=None, mark_starts=False, dpi=300):
    """Scatter every track's points coloured by travelled distance.

    Shared core of ``large_xy_plot`` and ``rose_graph``. Tracks are drawn in
    descending distance order so short (dark) tracks land on top; a
    viridis-reversed µm colour bar sits on the right.
    """
    if dist_max is None or not dist_max:
        col = df['travelled_dist'] if 'travelled_dist' in df else \
            df['distance_colour']
        dist_max = col.max()
    mpl, plt = _pyplot()
    fig, ax = plt.subplots(figsize=_A4_LANDSCAPE)
    fig.subplots_adjust(left=0.05, right=0.95)
    ax.set_axisbelow(True)

    if mark_starts:
        starts = df.groupby('TRACK_ID')[[x_col, y_col]].first()
        ax.scatter(starts[x_col] / scale, starts[y_col] / scale, marker='o',
                   color='black', s=1, lw=0)
    by_dist = df[['TRACK_ID', x_col, y_col, 'distance_colour']] \
        .sort_values('distance_colour', ascending=False)
    for _, track in by_dist.groupby('TRACK_ID', sort=False):
        ax.scatter(track[x_col] / scale, track[y_col] / scale, marker='.',
                   s=1, lw=0,
                   c=plt.cm.viridis_r(track['distance_colour']))

    mappable = mpl.cm.ScalarMappable(
        norm=mpl.colors.Normalize(vmin=dist_min, vmax=dist_max),
        cmap=plt.cm.viridis_r)
    fig.colorbar(mappable, ax=ax, fraction=0.02, pad=0.01, label='µm')
    ax.set_aspect('equal')
    ax.grid(True)
    ax.set_title(str(title))
    return fig, ax


def large_xy_plot(df, plot_title_name, save_path, px_to_micrometre=1,
                  dist_min=0, dist_max=None, dpi=300):
    """All tracks' raw XY paths in µm, start points marked black
    (reference plot_functions.py:109-188)."""
    fig, ax = _track_overview(df, 'POSITION_X', 'POSITION_Y', plot_title_name,
                              save_path, scale=px_to_micrometre,
                              dist_min=dist_min, dist_max=dist_max,
                              mark_starts=True, dpi=dpi)
    ax.set_xlabel('µm')
    ax.set_ylabel('µm')
    _finish(fig, save_path, dpi)


def rose_graph(df, plot_title_name, save_path, dist_min=0, dist_max=None,
               dpi=300):
    """All tracks re-origined at (0, 0) (reference plot_functions.py:191-257)."""
    fig, _ = _track_overview(df, 'x_norm', 'y_norm', plot_title_name,
                             save_path, dist_min=dist_min, dist_max=dist_max,
                             dpi=dpi)
    _finish(fig, save_path, dpi)


def _category_summaries(df, value_col, cut_off_category, cut_off_list):
    """Per-category (name, count, share, median, mean); NaN medians dropped.

    The share denominator is the first category's count, or the whole frame
    when that is empty (reference plot_functions.py:300-330 semantics).
    """
    counts = df[cut_off_category].value_counts()
    denominator = int(counts.get(cut_off_list[0][2], 0)) or df.shape[0]
    rows = []
    for entry in cut_off_list:
        name = entry[2]
        values = df.loc[df[cut_off_category] == name, value_col]
        median = values.median()
        if np.isnan(median):
            continue
        share = '{:.1%}'.format(len(values) / denominator) if denominator \
            else 'error'
        rows.append((name, len(values), share, median, values.mean()))
    return rows


def violin_plot(df, save_path, category, cut_off_category, cut_off_list,
                plot_title_name='\n\n', axis=None, dpi=300, verbose=False,
                y_min=None, y_max=None):
    """Seaborn violin split by category, annotated with count/median/mean
    per violin (reference plot_functions.py:260-370)."""
    import seaborn as sns
    plt = _pyplot()[1]
    y_limits = (y_min or None, y_max or None)
    font_md, font_sm = 8, 6
    plt.rcParams.update({
        'axes.titlesize': font_md, 'legend.fontsize': font_md,
        'axes.labelsize': font_sm, 'xtick.labelsize': font_md,
        'ytick.labelsize': font_md, 'figure.titlesize': font_md})
    for style in ('seaborn-v0_8-whitegrid', 'seaborn-whitegrid'):
        try:
            plt.style.use(style)
            break
        except OSError:
            continue

    fig = None
    if axis is None:
        fig = plt.figure(figsize=(_A4_LANDSCAPE[0] / 2, _A4_LANDSCAPE[1] / 2))
        axis = fig.add_subplot(111)
    axis.set_axisbelow(True)
    axis.grid(axis='y', which='major', alpha=0.80)
    violin_kwargs = dict(y=df[category], x=df[cut_off_category], orient='v',
                         cut=0, ax=axis, width=0.95, linewidth=1)
    try:
        sns.violinplot(density_norm='count', bw_method=.2, **violin_kwargs)
    except TypeError:  # older seaborn keyword set
        sns.violinplot(scale='count', bw=.2, **violin_kwargs)
    axis.set(ylim=y_limits)
    sns.despine(ax=axis, offset=0)
    axis.set_title('{}\n\n'.format(plot_title_name))

    summaries = _category_summaries(df, category, cut_off_category,
                                    cut_off_list)
    if summaries:
        anchors = np.linspace(0, 1, num=len(summaries), endpoint=False)
        for x_anchor, (name, count, share, median, mean) in \
                zip(anchors, summaries):
            axis.text(x_anchor + 0.015, 1.005,
                      '{}: {} ({})\nMedian: {:.2f}\nAverage:  {:.2f}'.format(
                          name, count, share, median, mean),
                      transform=axis.transAxes, size=font_sm)
    if fig is None:
        return axis
    _finish(fig, save_path, dpi, verbose=verbose)
    return None
