"""Seeded edge cases of the exact rect's tail (the cv2 centres, the
hull-edge finish and the rect select), as pixel blobs and as the
row-extreme tables the pipeline gives those kernels. numpy only:
``tests/test_torch_rect_tail.py`` and ``chip_smoke.py`` (phase 31) both
draw their edge cases from here.

The cases: no valid row, a single pixel, lines, discs with more than 32
strict corners, a 12-gon with more than 8 in-band candidates, bboxes past
the inverse-sqrt table or too wide for it, axis-aligned rects and
45-degree squares (equal areas and equal angles), a component whose
valid rows are no prefix (a hole row) and one taller than the tables.
"""

import numpy as np

#: the empty entry of a row-extreme table
BIG = 1 << 30
#: the tables' height R for ``edge_case_blobs``
EDGE_CASE_ROWS = 160


def row_tables(blobs, r):
    """Row-extreme tables (D, R) of pixel blobs (xs, ys); None = no row.
    Rows past R fold into the last, as ``component_stats_runs`` folds
    them.

    :return: row_min_x, row_max_x (D, R) int32; row_valid (D, R) bool;
        min_y (D,) int32 (BIG where a blob has no row)
    """
    d = len(blobs)
    rmin = np.full((d, r), BIG, np.int32)
    rmax = np.full((d, r), -BIG, np.int32)
    rvalid = np.zeros((d, r), bool)
    min_y = np.full(d, BIG, np.int32)
    for i, blob in enumerate(blobs):
        if blob is None:
            continue
        xs, ys = (np.asarray(a) for a in blob)
        y0 = ys.min()
        min_y[i] = y0
        for row in np.unique(ys):
            sel = ys == row
            k = min(row - y0, r - 1)
            rmin[i, k] = min(rmin[i, k], xs[sel].min())
            rmax[i, k] = max(rmax[i, k], xs[sel].max())
            rvalid[i, k] = True
    return rmin, rmax, rvalid, min_y


def disc(radius, cx=300, cy=200):
    """The pixels of a disc (more than 32 strict corners from radius ~40)."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    m = xs ** 2 + ys ** 2 <= radius ** 2 + radius
    return xs[m] + cx, ys[m] + cy


def twelve_gon():
    """|x|, |y| <= 72 and 2|x| + |y|, |x| + 2|y| <= 161: the axis edges'
    areas (144^2) and the eight (1, 2)-class edges' (322^2 / 5) lie
    within the surrogate band (161^2 ~ 5 * 72^2), so more than 8 edges
    are in band."""
    ys, xs = np.mgrid[-72:73, -72:73]
    ax, ay = np.abs(xs), np.abs(ys)
    m = (2 * ax + ay <= 161) & (ax + 2 * ay <= 161)
    return xs[m] + 400, ys[m] + 100


def edge_case_blobs():
    """The module docstring's edge cases as pixel blobs, in this order:
    no row (0), a pixel (1), four lines (2-5), two discs (6, 7), the
    12-gon (8), two bboxes wider than the table (9, 10), five rects,
    three diamonds, the hole row and the tall component (the last)."""
    blobs = [None,                                             # no valid row
             (np.array([40]), np.array([50])),                 # one pixel
             (np.arange(30, 45), np.full(15, 60)),             # lines
             (np.full(12, 33), np.arange(20, 32)),
             (np.arange(10, 22), np.arange(40, 52)),
             (np.arange(10, 13), np.array([40, 41, 42])),
             disc(45), disc(60),                       # > 32 strict corners
             twelve_gon(),                             # > 8 in band
             # wider than the table: vlen2 past it
             (np.tile(np.arange(0, 400), 2),
              np.concatenate([np.full(400, 10), np.full(400, 11)])),
             (np.tile(np.arange(0, 310), 2),
              np.concatenate([np.full(310, 7), np.full(310, 8)]))]
    # equal surrogate areas and equal angles: axis-aligned rects and
    # 45-degree squares (all four edges tie)
    for w, h in ((1, 2), (2, 1), (3, 3), (5, 2), (7, 7)):
        ys, xs = np.mgrid[0:h, 0:w]
        blobs.append((xs.ravel() + 20, ys.ravel() + 30))
    for k in (2, 3, 6):
        ys, xs = np.mgrid[-k:k + 1, -k:k + 1]
        m = np.abs(xs) + np.abs(ys) <= k
        blobs.append((xs[m] + 50, ys[m] + 60))
    # a hole row (valid rows no prefix) and a component taller than R
    xs, ys = disc(6)
    blobs.append((xs[ys != 200], ys[ys != 200]))
    blobs.append((np.full(200, 5), np.arange(200)))
    return blobs
