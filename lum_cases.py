"""Seeded cases of the luminosity paths' two kernels (``csrc/luminosity.cu``,
the rect mean, and ``csrc/pixel_finish.cu``, the pixel-table finish),
numpy only (and cv2 for the minAreaRect rects), for the CPU tests against
``ysmr_tpu`` and the kernels' design emulations
(``tests/test_torch_rect_mean.py``, ``tests/test_torch_pixel_finish.py``)
and for their ``cuda`` twins (``tests/test_torch_lum_cuda.py``) and smoke
phase 36.

- ``rect_case(name)``: (gray (T, H, W) uint8 or int32, [cx, cy, w, h,
  angle] (T, D) float32, valid (T, D) bool, win) for each of
  ``RECT_CASES``: windows of 16, 32 and 64; rects larger than the window
  and than the frame; windows clipped at every frame border and corner;
  sides of 0; angles of 0, +-45, +-90, +-180; int32 gray (frames mode's)
  with values past a byte; a frame smaller than the window; few valid
  slots; uniform random rects and ``cv2.minAreaRect`` rects (the design
  emulation's 10^4); for the kernel's tiles (``TILING_CASES``): boxes of
  the window's full 64 x 64 that span several warps' pixel ranges, empty
  boxes between full ones, a frame with no valid slot and valid slots
  that are no prefix (``tiling``), and corners far past +-2^13, where the
  int32 cross products wrap (``huge_corners``).
- ``finish_case(name)``: (px_x, px_y, valid, marker (T, F), h, w,
  double_threshold, max_det, max_bh, plane_f) raster-order pixel lists of
  ``FINISH_CASES``: random blobs in lists of several 2048-slot tiles (F no
  multiple of the tile), frames with 0, 1 and max_det + 1 components, a
  component taller than max_bh, an invalid frame, a list filled to F, a
  component whose pixels straddle tiles, warps whose lanes hold 32, 2 and
  1 distinct labels (``distinct_labels``), and a root 31 lanes back in the
  previous tile of 2048 slots (``root_back``).
- ``own_root_lists(t, f, h, w)``: a list of F pixels a frame with its
  labels made directly (every pixel its own root, and a few components of
  several pixels), for lists past any tile count (the finish on lists of
  more than 25,165,824 slots).
"""

import numpy as np

H, W = 120, 160

#: the cases of the rect mean kernel's tiling and of its wrapping corners
TILING_CASES = ('tiling', 'huge_corners')
RECT_CASES = ('win16', 'win32', 'win64', 'larger_than_window', 'borders',
              'degenerate', 'angles', 'int32_gray', 'small_frame',
              'sparse_valid', 'random', 'min_area') + TILING_CASES


def random_rects(rng, n, h=H, w=W, margin=25.0, max_side=16.0):
    """float32 rect parameters; the angles of cv2's (-90, 0] convention
    with the exact ends, then any angle; a fifth at half-pixel centers."""
    cx = rng.uniform(margin, w - margin, n).astype(np.float32)
    cy = rng.uniform(margin, h - margin, n).astype(np.float32)
    rw = rng.uniform(0.5, max_side, n).astype(np.float32)
    rh = rng.uniform(0.5, max_side, n).astype(np.float32)
    ang = rng.uniform(-90, 0, n).astype(np.float32)
    ang[: n // 20] = -90.0
    ang[n // 20: n // 10] = 0.0
    ang[n - n // 10:] = rng.uniform(-180, 180, n // 10)
    q = n // 5
    cx[q:2 * q] = np.round(cx[q:2 * q] * 2) / 2
    cy[q:2 * q] = np.round(cy[q:2 * q] * 2) / 2
    return [cx, cy, rw, rh, ang]


def min_area_rects(seed, n, h=H, w=W):
    """cv2.minAreaRect of n random ellipse blobs placed over the frame:
    half-pixel centers, sides and angles of small integer edge vectors,
    where a truncated corner often sits on a knife edge."""
    import cv2
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((48, 48), np.uint8)
        cv2.ellipse(img, (int(rng.integers(16, 32)),
                          int(rng.integers(16, 32))),
                    (int(rng.integers(1, 12)), int(rng.integers(1, 5))),
                    float(rng.uniform(0, 180)), 0, 360, 255, -1)
        cnts, _ = cv2.findContours(img, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
        (cx, cy), (rw, rh), a = cv2.minAreaRect(cnts[0])
        out.append((cx + rng.integers(-8, w - 40),
                    cy + rng.integers(-8, h - 40), rw, rh, a))
    return [np.array(c, np.float32) for c in zip(*out)]


def _frames(rng, t, h=H, w=W):
    return rng.integers(0, 256, (t, h, w), dtype=np.uint8)


def rect_case(name):
    """The rect mean's inputs of case ``name`` (see the module
    docstring)."""
    rng = np.random.default_rng(RECT_CASES.index(name) + 100)
    t, d, win, h, w = 3, 200, 48, H, W
    gray = None
    if name in ('win16', 'win32', 'win64'):
        win = int(name[3:])
        params = random_rects(rng, t * d, max_side=40.0)
    elif name == 'larger_than_window':
        params = random_rects(rng, t * d, margin=0.0, max_side=220.0)
    elif name == 'borders':
        # centers on and past every border and corner; sides up to 30
        xs = np.array([-6, -1, 0, 2, w / 2, w - 3, w - 1, w, w + 4],
                      np.float32)
        ys = np.array([-6, -1, 0, 2, h / 2, h - 3, h - 1, h, h + 4],
                      np.float32)
        gx, gy = np.meshgrid(xs, ys)
        k = gx.size
        reps = -(-t * d // k)
        cx = np.tile(gx.ravel(), reps)[:t * d] + \
            rng.uniform(-0.5, 0.5, t * d).astype(np.float32)
        cy = np.tile(gy.ravel(), reps)[:t * d] + \
            rng.uniform(-0.5, 0.5, t * d).astype(np.float32)
        params = [cx.astype(np.float32), cy.astype(np.float32),
                  rng.uniform(0, 30, t * d).astype(np.float32),
                  rng.uniform(0, 30, t * d).astype(np.float32),
                  rng.uniform(-180, 180, t * d).astype(np.float32)]
    elif name == 'degenerate':
        params = random_rects(rng, t * d)
        n = t * d
        params[2][: n // 3] = 0.0
        params[3][n // 3: 2 * n // 3] = 0.0
        params[2][2 * n // 3:] = 0.0
        params[3][2 * n // 3:] = 0.0
    elif name == 'angles':
        params = random_rects(rng, t * d)
        angs = np.array([0, 45, -45, 90, -90, 180, -180, 30, -60],
                        np.float32)
        params[4] = angs[rng.integers(0, len(angs), t * d)]
        params[0] = (np.round(params[0] * 2) / 2).astype(np.float32)
        params[1] = (np.round(params[1] * 2) / 2).astype(np.float32)
        params[2] = np.round(params[2]).astype(np.float32)
        params[3] = np.round(params[3]).astype(np.float32)
    elif name == 'int32_gray':
        params = random_rects(rng, t * d, max_side=30.0)
        gray = rng.integers(0, 256, (t, h, w)).astype(np.int32)
        gray[:, ::7, ::5] = rng.integers(0, 100000, gray[:, ::7, ::5].shape)
    elif name == 'small_frame':
        h, w = 20, 30
        params = random_rects(rng, t * d, h=h, w=w, margin=0.0,
                              max_side=25.0)
    elif name == 'random':
        t, d = 4, 2500
        params = random_rects(rng, t * d)
    elif name == 'min_area':
        t, d = 4, 2500
        params = min_area_rects(7, t * d)
    elif name == 'tiling':
        t, d, win = 4, 300, 64
        params = random_rects(rng, t * d, max_side=30.0)
        # frame 0: every third slot a rect past the window: a 64 x 64 box
        big = np.arange(0, d, 3)
        params[2][big] = rng.uniform(100, 160, len(big))
        params[3][big] = rng.uniform(100, 160, len(big))
        params[4][big] = rng.uniform(-180, 180, len(big))
        # frame 2: every other slot centered far outside: an empty box
        far = 2 * d + np.arange(0, d, 2)
        params[0][far] = -400.0
        params[1][far] = 700.0
    elif name == 'huge_corners':
        params = random_rects(rng, t * d)
        # sides up to 1.9e9: corners up to +-2^31, cross products wrap
        n = t * d
        params[2][: n // 2] = rng.uniform(3e4, 1.9e9, n // 2)
        params[3][n // 4: 3 * n // 4] = rng.uniform(2e4, 1.9e9, n // 2)
    else:
        params = random_rects(rng, t * d)
    if gray is None:
        gray = _frames(rng, t, h, w)
    valid = rng.random((t, d)) < (0.1 if name == 'sparse_valid' else 0.95)
    if name == 'tiling':
        valid[0] = (np.arange(d) % 3) == 0
        valid[1] = False
        valid[2] = True
        valid[3] = rng.random(d) < 0.5
    params = [np.ascontiguousarray(p.reshape(t, d), np.float32)
              for p in params]
    return gray, params, valid, win


FINISH_CASES = ('blobs', 'counts_0_1_overflow', 'tall', 'invalid_frame',
                'full_list', 'straddle', 'single_threshold',
                'distinct_labels', 'root_back')


def _blob_masks(rng, t, h, w, n_blobs):
    masks = np.zeros((t, h, w), bool)
    for k in range(t):
        for _ in range(n_blobs):
            x0 = int(rng.integers(0, w - 6))
            y0 = int(rng.integers(0, h - 6))
            hh, ww = int(rng.integers(1, 7)), int(rng.integers(1, 9))
            masks[k, y0:y0 + hh, x0:x0 + ww] = True
        masks[k] &= rng.random((h, w)) < 0.93
    return masks


def lists_of(masks, markers, f):
    """Raster-order pixel lists (int32 x and y, bool valid prefix and
    marker) of (T, H, W) masks, cut at F; zero past each frame's count."""
    t = masks.shape[0]
    px_x = np.zeros((t, f), np.int32)
    px_y = np.zeros((t, f), np.int32)
    valid = np.zeros((t, f), bool)
    marker = np.zeros((t, f), bool)
    for k in range(t):
        ys, xs = np.nonzero(masks[k])
        n = min(len(ys), f)
        px_x[k, :n], px_y[k, :n] = xs[:n], ys[:n]
        valid[k, :n] = True
        marker[k, :n] = markers[k][ys[:n], xs[:n]]
    return px_x, px_y, valid, marker


def finish_case(name):
    """The pixel finish's wire of case ``name`` (see the module
    docstring): a dict of ``px_x``, ``px_y``, ``marker`` (T, F), the pixel
    ``counts`` and ``frame_valid`` (T,), ``valid`` (T, F) (the count
    prefix of a valid frame), and ``h``, ``w``, ``double_threshold``,
    ``max_det``, ``max_bh`` and ``plane_f`` (the plane's width)."""
    rng = np.random.default_rng(FINISH_CASES.index(name) + 200)
    h, w, t, f = 96, 128, 4, 5000
    max_det, max_bh, double = 24, 8, True
    n_blobs = {'full_list': 120, 'blobs': 300}.get(name, 40)
    if name == 'blobs':
        h, w, f = 160, 240, 9000
    masks = _blob_masks(rng, t, h, w, n_blobs)
    if name == 'counts_0_1_overflow':
        masks[0] = False
        masks[1] = False
        masks[1, 40:44, 50:60] = True
        masks[2] = False
        for i in range(max_det + 1):
            y, x = 4 + (i // 8) * 12, 4 + (i % 8) * 15
            masks[2, y:y + 3, x:x + 4] = True
    elif name == 'tall':
        masks[:, 5:60, 20:23] = True
        masks[:, 10:90, 100] = True
    elif name == 'full_list':
        f = 1500
    elif name == 'straddle':
        # a wide band whose rows span two tiles of 2048 slots
        masks[:, 30:50, :] |= rng.random((t, 20, w)) < 0.9
    elif name == 'single_threshold':
        double = False
    elif name == 'distinct_labels':
        double = False
        masks[:] = False
        # frame 0: isolated pixels, 32 labels a warp
        masks[0, ::2, ::2] = True
        # frame 1: two bars of 16 columns, a row of 32 pixels a warp
        masks[1, 2:90, 8:24] = True
        masks[1, 2:90, 60:76] = True
        # frame 2: one block, one label a warp
        masks[2, 10:80, 10:106] = True
        masks[3] = masks[0] | masks[1]
        masks[3, 40:60] = masks[2, 40:60]
    elif name == 'root_back':
        # row 0: 2017 isolated pixels, then a run of 40 from slot 2017:
        # slot 2048 (lane 0 of its warp, tile 1) has its root at slot 2017
        # (lane 1 of the previous warp, tile 0)
        double = False
        h, w, f = 6, 4200, 2600
        masks = np.zeros((t, h, w), bool)
        masks[:, 0, 0:4034:2] = True
        masks[:, 0, 4034:4074] = True
        masks[:, 1, 4070:4150] = True
        masks[:, 3, 0:500:3] = True
        masks[1:, 4, 100:300] = rng.random((t - 1, 200)) < 0.7
    markers = masks & (rng.random(masks.shape) < 0.4)
    px_x, px_y, valid, marker = lists_of(masks, markers, f)
    counts = valid.sum(1).astype(np.int32)
    frame_valid = np.ones(t, bool)
    if name == 'invalid_frame':
        frame_valid[2] = False
        valid[2] = False
    return dict(px_x=px_x, px_y=px_y, marker=marker, counts=counts,
                frame_valid=frame_valid, valid=valid, h=h, w=w,
                double_threshold=double, max_det=max_det, max_bh=max_bh,
                plane_f=min(f, 300 if name == 'blobs' else f))


def own_root_lists(t, f, h, w):
    """F >= 1 pixels a frame in raster order from (0, 0), each its own
    root, except a few components of several pixels: a run of 40 in row 0
    from x = 3, a 3 x 3 block at (5, 2) and, in the last full row, a run
    of 7 at its start. Returns (lab_fg, keep, px_x, px_y, valid) as numpy
    arrays (int32, and bool keep and valid), every slot valid and kept;
    needs h * w >= f and w >= 64."""
    lin = np.arange(f, dtype=np.int64)
    px_y = (lin // w).astype(np.int32)
    px_x = (lin % w).astype(np.int32)
    lab = lin.astype(np.int32)
    lab[3:43] = 3                                # a run of row 0
    for dy in range(3):                          # a 3 x 3 block
        y = 2 + dy
        if (y + 1) * w <= f:
            lab[y * w + 5: y * w + 8] = 2 * w + 5
    last = f // w - 1
    if last > 4:
        lab[last * w: last * w + 7] = last * w
    shape = (t, f)
    return (np.broadcast_to(lab, shape).copy(),
            np.ones(shape, bool),
            np.broadcast_to(px_x, shape).copy(),
            np.broadcast_to(px_y, shape).copy(),
            np.ones(shape, bool))
