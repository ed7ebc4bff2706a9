"""Seeded edge cases of the pixel-table branch's two kernels off the default
path: the table CC of ``use table cc`` (``ysmr_tpu_torch/ops/cc.py::
cc_labels_table``, ``csrc/table_cc.cu``) and the run wire's expansion of
``run cc = off`` (``ysmr_tpu_torch/ops/run_cc.py::expand_runs``,
``csrc/expand_runs.cu``), with numpy only. Each case is cut to the
kernel's tiling, given as arguments, so that the CPU tests can emulate the
designs at small tiles on small tables and the ``cuda`` tests and
``chip_smoke.py`` (phase 37) can run the kernels at their own.
"""

import numpy as np

#: the table CC's cases: a run that crosses a tile's edge and a warp's
#: edge (long rows with holes); a halo wider than the shared memory holds
#: (two dense rows wider than the halo); single-pixel runs joined only by
#: diagonals (a checkerboard, with few markers and with every pixel a
#: marker); a valid prefix that ends mid-tile and mid-warp; a full frame
#: (no invalid slot, one marker; and no marker); a component of many
#: marker runs (a filled disc)
TABLE_CASES = ('run_across_tile', 'wide_halo', 'checkerboard',
               'prefix_mid_tile', 'full_frame', 'many_marker_runs')

#: the expansion's cases: F not a multiple of the tile; runs of 31 slots
#: across the tiles' edges; a run cut at F; the pixels filling F exactly;
#: a frame with no run (stale words past its count); counts below 0 and
#: above R
EXPAND_CASES = ('f_not_tile_multiple', 'run_across_tile', 'run_cut_at_f',
                'carry_exactly_f', 'no_runs', 'counts_out_of_range')


def _table(masks, markers, f):
    """(T, H, W) masks and markers -> (lin (T, F) int32, valid, marker
    (T, F) bool): each frame's pixels as a raster prefix (cut at F), the
    slots past them invalid with stale lins."""
    t, h, w = masks.shape
    rng = np.random.default_rng(t * 7919 + h * 31 + w)
    lin = rng.integers(0, h * w, (t, f)).astype(np.int32)
    valid = np.zeros((t, f), bool)
    marker = rng.random((t, f)) < 0.5
    for i in range(t):
        ys, xs = np.nonzero(masks[i])
        n = min(len(xs), f)
        lin[i, :n] = (ys * w + xs)[:n]
        valid[i, :n] = True
        marker[i, :n] = markers[i][ys, xs][:n]
    return lin, valid, marker


def table_case(name, tile, window, seed=0):
    """One of ``TABLE_CASES`` at a tile of ``tile`` slots and a window of
    at most ``window`` staged slots: (lin, valid, marker, h, w), the valid
    entries of each frame a prefix in ascending lin."""
    rng = np.random.default_rng(seed + TABLE_CASES.index(name))
    if name == 'run_across_tile':
        h, w = 6, tile + tile // 2 + 5
        masks = rng.random((2, h, w)) > 0.03
        marks = masks & (rng.random(masks.shape) < 0.02)
        f = h * w + 7
    elif name == 'wide_halo':
        h, w = 5, window + 97
        masks = rng.random((2, h, w)) > 0.03
        masks[1, 2] = rng.random(w) < 0.2
        marks = masks & (rng.random(masks.shape) < 0.03)
        f = h * w
    elif name == 'checkerboard':
        h = w = int(np.sqrt(8 * tile)) + 3
        yy, xx = np.mgrid[:h, :w]
        board = (yy + xx) % 2 == 0
        masks = np.stack([board, board])
        marks = np.stack([board & (rng.random((h, w)) < 0.05), board])
        f = int(board.sum())
    elif name == 'prefix_mid_tile':
        h, w = 40, 3 * tile // 8 + 11
        masks = rng.random((2, h, w)) < 0.35
        marks = masks & (rng.random(masks.shape) < 0.2)
        f = 4 * tile
        lin, valid, marker = _table(masks, marks, f)
        for i, n in enumerate((tile + tile // 2 - 3, 37)):
            valid[i, n:] = False
        return lin, valid, marker, h, w
    elif name == 'full_frame':
        w = 64
        h = max(5 * tile // (2 * w), 2)
        masks = np.ones((2, h, w), bool)
        marks = np.zeros_like(masks)
        marks[0, h // 2, w // 3] = True
        f = h * w
    elif name == 'many_marker_runs':
        rad = int(np.sqrt(3 * tile / np.pi)) + 2
        h = w = 2 * rad + 9
        yy, xx = np.mgrid[:h, :w]
        disc = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 <= rad * rad
        masks = np.stack([disc, disc & (rng.random((h, w)) > 0.1)])
        marks = masks & (rng.random(masks.shape) < 0.6)
        f = int(disc.sum()) + 5
    else:
        raise ValueError('unknown table case {}'.format(name))
    return _table(masks, marks, f) + (h, w)


def _words(rng, n, lens=None, gap=40):
    """n run words in ascending lin: lengths 1-31 (or ``lens``), random
    gaps and marker bits."""
    lens = rng.integers(1, 32, n) if lens is None else np.asarray(lens)
    starts = np.cumsum(lens + rng.integers(1, gap, n)) - lens
    marks = rng.random(n) < 0.4
    return (starts.astype(np.uint32) |
            (marks.astype(np.uint32) << 26) |
            (lens.astype(np.uint32) << 27))


def expand_case(name, tile, chunk, seed=0):
    """One of ``EXPAND_CASES`` at a tile of ``tile`` output slots and
    chunks of ``chunk`` runs: (runs (T, R) uint32, counts (T,) int32, f),
    each frame's words below its count of lengths 1-31 (the encoder's
    contract), stale words past it."""
    rng = np.random.default_rng(seed + 17 * EXPAND_CASES.index(name))
    n = 2 * chunk + chunk // 3 + 3          # a frame's runs: three chunks
    r = n + 13
    runs = np.stack([_words(rng, r) for _ in range(3)])
    counts = np.array([n, n - chunk // 2, n // 3], np.int32)
    if name == 'run_across_tile':
        runs[0] = _words(rng, r, lens=np.full(r, 31), gap=2)
    totals = [int((runs[i, :counts[i]] >> 27).astype(np.int64).sum())
              for i in range(3)]
    if name == 'f_not_tile_multiple':
        f = max(totals) + tile // 3 + 1
        if f % tile == 0:
            f += 1
    elif name == 'run_across_tile':
        f = totals[0] + tile + 3
    elif name == 'run_cut_at_f':
        # the table ends 5 slots into frame 0's word of the table's end
        ends = np.cumsum((runs[0, :counts[0]] >> 27).astype(np.int64))
        k = max(int(np.searchsorted(ends, 2 * tile + 1)), 1)
        f = int(ends[k - 1]) + 5
        runs[0, k] = (runs[0, k] & 0x07FFFFFF) | np.uint32(20 << 27)
    elif name == 'carry_exactly_f':
        f = totals[0]
    elif name == 'no_runs':
        counts[1] = 0
        f = max(totals) + 9
    else:
        counts[0] = -3
        counts[2] = r + 5
        f = int((runs[2] >> 27).astype(np.int64).sum()) + 2 * tile + 1
    return runs, counts, f
