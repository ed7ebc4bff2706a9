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

Cases that split the kernels' layouts unevenly (``band_blobs``,
``table_edge_blobs``, ``select_arrays``): octagons with exactly 8 and 9
edges in the surrogate band, lattice squares whose edge vector lands on
the inverse-sqrt table's last entry and one past it, and rect-select
inputs with every candidate valid, none valid, K = 1, 2 and 191, at D
no multiple of a block's components.
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


def octagon(w, h, s, t, cut=None, x0=40, y0=30):
    """The lattice points of 0 <= x <= w, 0 <= y <= h, s[0] <= x + y <=
    s[1], t[0] <= x - y <= t[1] and, with ``cut`` = (a, b, c), a x + b y
    <= c, shifted by (x0, y0)."""
    ys, xs = np.mgrid[0:h + 1, 0:w + 1]
    m = (xs + ys >= s[0]) & (xs + ys <= s[1]) & (xs - ys >= t[0]) & \
        (xs - ys <= t[1])
    if cut:
        a, b, c = cut
        m &= a * xs + b * ys <= c
    return xs[m] + x0, ys[m] + y0


def band_blobs():
    """Exactly 8 edges in the surrogate band (an octagon whose axis and
    diagonal boxes have the same area, 10 x 12 = 15 x 16 / 2: ``ok``),
    then exactly 9 (two octagons with a corner cut whose edge ties them:
    ``ok`` False)."""
    return [octagon(10, 12, (3, 18), (-9, 7)),
            octagon(6, 8, (2, 10), (-7, 5), (2, 1, 14)),
            octagon(8, 6, (2, 10), (-5, 7), (1, 2, 14))]


#: (max_w, max_h) of the inverse-sqrt table of ``table_edge_blobs``: 26
#: entries, the last 3^2 + 4^2 = 25
TABLE_EDGE = (3, 4)


def lattice_square(u, x0=60, y0=20):
    """The lattice points of the square with edge vectors u and (-u_y,
    u_x) from (x0, y0)."""
    a, b = u
    corners = np.array([[0, 0], [a, b], [a - b, b + a], [-b, a]])
    lo, hi = corners.min(0), corners.max(0)
    ys, xs = np.mgrid[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
    inside = np.ones_like(xs, bool)
    for i in range(4):
        p, q = corners[i], corners[(i + 1) % 4]
        inside &= (q[0] - p[0]) * (ys - p[1]) - (q[1] - p[1]) * \
            (xs - p[0]) >= 0
    return xs[inside] + x0, ys[inside] + y0


def table_edge_blobs():
    """Squares whose four in-band edges have |v|^2 = 25, the last entry of
    the ``TABLE_EDGE`` table (``ok``), and 26, one past it (``ok`` False)."""
    return [lattice_square(u) for u in ((3, 4), (4, 3), (5, 1), (1, 5))]


#: the rect select's uneven cases: (name, K, D, share of valid candidates)
SELECT_CASES = (('all 94 valid', 95, 4099, 1.0),
                ('none valid', 95, 3001, 0.0),
                ('K=1', 1, 77, 1.0),
                ('K=2', 2, 65, 0.5),
                ('K=191 (R=96)', 191, 2049, 0.8),
                ('K=127 (R=64)', 127, 1001, 0.3))


def select_arrays(rng, k, d, frac):
    """Seeded rect-select inputs (min_u, max_u, min_v, max_v, dx, dy,
    angles, valid): small integer extents and directions (equal areas in
    many candidates), angles 0, -0, 0.25, 0.5 (equal angles), each hull
    candidate valid with probability ``frac``; the appended candidate
    (1, 0) last, its direction implicit (dx, dy are the K - 1 hull
    candidates'); the first five components without a valid point."""
    f32 = np.float32
    mnu = rng.integers(-40, 0, (d, k)).astype(f32)
    mxu = mnu + rng.integers(0, 6, (d, k)).astype(f32)
    mnv = rng.integers(-40, 0, (d, k)).astype(f32)
    mxv = mnv + rng.integers(0, 6, (d, k)).astype(f32)
    dx = rng.integers(1, 4, (d, k)).astype(f32)
    dy = rng.integers(0, 4, (d, k)).astype(f32)
    dx[:, -1], dy[:, -1] = 1, 0
    ang = rng.choice(np.array([0.0, -0.0, 0.25, 0.5], f32), (d, k - 1))
    valid = rng.random((d, k - 1)) < frac
    mnu[:5], mxu[:5] = 3e38, -3e38
    return [np.ascontiguousarray(a) for a in
            (mnu, mxu, mnv, mxv, dx[:, :k - 1], dy[:, :k - 1], ang, valid)]
