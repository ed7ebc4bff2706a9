"""The exact rect mean of the PyTorch port (ysmr_tpu_torch/ops/
luminosity.py): its plain version against the jitted ysmr_tpu function on
the edge cases of the root module ``lum_cases.py``, a numpy emulation of
the CUDA kernel's design (``csrc/luminosity.cu``) against the plain
version, and the wrapper's routes and refusals. The kernel itself is held
to the plain version on the card by ``tests/test_torch_lum_cuda.py``.

Tolerance: bit-equal wherever the port's integer corners equal the JAX
function's (they differ on a knife edge now and then: OpenCV 4's float64
cos/sin against XLA's float32 ones, pinned in
``tests/test_torch_luminosity.py``); after the corners everything is
integer arithmetic and one float32 division and product.
"""

import jax
import numpy as np
import pytest
import torch

from lum_cases import RECT_CASES, TILING_CASES, rect_case
from ysmr_tpu.ops import luminosity as jlum
from ysmr_tpu_torch.ops import luminosity as lum

torch.set_num_threads(1)

#: the cases whose window fits the frame (JAX's dynamic_slice needs it),
#: without those of the kernel's tiling and wrapping corners (where the
#: float32 corners of ysmr_tpu differ on most rects)
JAX_CASES = tuple(c for c in RECT_CASES
                  if c not in ('small_frame', 'random', 'min_area') +
                  TILING_CASES)


def _plain(gray, params, valid, win):
    return lum.rect_mean_luminosity_plain(
        torch.from_numpy(gray), *(torch.from_numpy(p) for p in params),
        torch.from_numpy(valid), win=win).numpy()


def _same_corners(params):
    """(T, D) bool: the port's integer corner set equals the jitted JAX
    function's."""
    flat = [p.reshape(-1) for p in params]
    ours = lum.box_points_int(*(torch.from_numpy(p) for p in flat)).numpy()
    theirs = np.asarray(jax.jit(jax.vmap(jlum.box_points_int))(*flat))
    n = len(flat[0])
    same = (np.sort(ours.view(np.int64).reshape(n, 4), 1) ==
            np.sort(theirs.view(np.int64).reshape(n, 4), 1)).all(axis=1)
    return same.reshape(params[0].shape)


@pytest.mark.parametrize('case', JAX_CASES)
def test_plain_matches_jax_on_edge_cases(case):
    """Windows of 16, 32 and 64, rects larger than the window, windows
    clipped at every border, zero sides, the exact angles, int32 gray and
    sparse validity: the plain version equals the jitted JAX function
    wherever the corners agree, and 0 on every invalid slot."""
    gray, params, valid, win = rect_case(case)
    ours = _plain(gray, params, valid, win)
    assert ours.dtype == np.float32 and ours.shape == valid.shape
    jfn = jax.jit(jlum.rect_mean_luminosity, static_argnames=('win',))
    ref = np.stack([np.asarray(jfn(gray[i].astype(np.int32),
                                   *(p[i] for p in params), valid[i],
                                   win=win)) for i in range(len(gray))])
    same = _same_corners(params)
    np.testing.assert_array_equal(ours[same], ref[same])
    assert (ours[~valid] == 0).all()
    assert (ours[valid] > 0).sum() > 0.5 * valid.sum() or \
        case == 'degenerate'
    assert same.mean() > 0.97


# ---- the kernel's design in numpy ----

def _wrap32(a):
    return np.asarray(a, np.int64).astype(np.int32)


def _corners(params):
    """Lane k's corners: OpenCV 4's RotatedRect::points, every float32
    operation rounded on its own; (N, 4) int32 x and y."""
    cx, cy, w, h, ang = (p.reshape(-1) for p in params)
    a = ang.astype(np.float64) * np.pi / 180.0
    b = np.cos(a).astype(np.float32) * np.float32(0.5)
    s = np.sin(a).astype(np.float32) * np.float32(0.5)
    x0 = (cx - s * h) - b * w
    y0 = (cy + b * h) - s * w
    x1 = (cx + s * h) - b * w
    y1 = (cy - b * h) - s * w
    two = np.float32(2)
    xs = np.stack([x0, x1, two * cx - x0, two * cx - x1], 1)
    ys = np.stack([y0, y1, two * cy - y0, two * cy - y1], 1)
    return np.trunc(xs).astype(np.int32), np.trunc(ys).astype(np.int32)


def _on_edge(x0, y0, x1, y1, px, py):
    """The kernel's on_edge: floor divisions replaced by the int64
    remainder test. Endpoints (n, 1), pixels (n, P)."""
    swap = (x1 < x0) | ((x1 == x0) & (y1 < y0))
    ax0, ay0 = np.where(swap, x1, x0), np.where(swap, y1, y0)
    dx = _wrap32(np.where(swap, x0, x1).astype(np.int64) - ax0)
    dy = _wrap32(np.where(swap, y0, y1).astype(np.int64) - ay0)
    sy = np.where(dy >= 0, 1, -1).astype(np.int64)
    adx, ady = _wrap32(np.abs(dx.astype(np.int64))), \
        _wrap32(np.abs(dy.astype(np.int64)))
    x_major = adx >= ady
    point = (adx == 0) & (ady == 0)
    # x-major
    kx = _wrap32(px.astype(np.int64) - ax0).astype(np.int64)
    m = _wrap32(py.astype(np.int64) - ay0).astype(np.int64) * sy
    n = _wrap32(2 * kx * ady + adx - 1).astype(np.int64)
    d = np.maximum(_wrap32(2 * adx.astype(np.int64)), 1).astype(np.int64)
    r = n - m * d
    on_x = (kx >= 0) & (kx <= adx) & np.where(adx > 0, (r >= 0) & (r < d),
                                              m == 0)
    # y-major
    ky = m
    c = kx
    n = 2 * ky * adx.astype(np.int64) + ady.astype(np.int64) - 1
    d = np.maximum(_wrap32(2 * ady.astype(np.int64)), 1).astype(np.int64)
    r = n - c * d
    on_y = (ky >= 0) & (ky <= ady) & np.where(ady > 0, (r >= 0) & (r < d),
                                              c == 0)
    return np.where(point, (px == ax0) & (py == ay0),
                    np.where(x_major, on_x, on_y))


def _edge_params(x0, y0, x1, y1):
    """The walk's closed form of edge (x0, y0) -> (x1, y1) (the corners
    within +-2^13): the range [lo, lo + len] of the major coordinate, the
    major axis and the sign s of t = s * c; a point edge gets an empty
    range. Arrays (n,)."""
    swap = (x1 < x0) | ((x1 == x0) & (y1 < y0))
    ax0, ay0 = np.where(swap, x1, x0), np.where(swap, y1, y0)
    dx = np.where(swap, x0, x1).astype(np.int64) - ax0
    dy = np.where(swap, y0, y1).astype(np.int64) - ay0
    sy = np.where(dy >= 0, 1, -1)
    adx, ady = np.abs(dx), np.abs(dy)
    point = (adx == 0) & (ady == 0)
    x_major = adx >= ady
    lo = np.where(x_major, ax0, np.where(sy > 0, ay0, ay0 - ady))
    length = np.where(x_major, adx, ady)
    sign = np.where(x_major, -sy, sy) * np.where(swap, -1, 1)
    lo = np.where(point, np.iinfo(np.int32).min, lo)
    return lo, np.where(point, 0, length), x_major, sign


def walk_order(pixels, warps=8):
    """The pixels of a tile's flat list in the walk's order: the warps'
    contiguous ranges of 32-pixel passes, pixel p to lane p % 32 of pass
    p // 32. Returns (p, warp) of each visited pixel."""
    passes = -(-pixels // 32)
    out_p, out_w = [], []
    for wp in range(warps):
        g0, g1 = wp * passes // warps, (wp + 1) * passes // warps
        p = np.arange(g0 * 32, g1 * 32)
        p = p[p < pixels]
        out_p.append(p)
        out_w.append(np.full(len(p), wp))
    return np.concatenate(out_p), np.concatenate(out_w)


def kernel_emulation(gray, params, valid, win, tile=256):
    """``csrc/luminosity.cu``'s design: per tile of ``tile`` slots the
    corners, the walk boxes (each quad's bounding box clipped to the
    window and the frame) and their compact list with each box's first
    pixel; the tile's box pixels walked in the warps' order (each pixel
    visited once, whichever box and warp it falls to); the cross products
    as ex * y + (-ey) * x + k modulo 2^32; where they fail, the closed-form
    edge tests for corners within +-2^13 (checked here against the
    remainder tests) and the remainder tests elsewhere; the int32 sums and
    counts, then the means."""
    t, img_h, img_w = gray.shape
    qx, qy = _corners(params)
    v = valid.reshape(-1)
    n_slots = len(v)
    d = params[0].shape[1]
    mnx, mxx = qx.min(1).astype(np.int64), qx.max(1).astype(np.int64)
    mny, mxy = qy.min(1).astype(np.int64), qy.max(1).astype(np.int64)
    x_org = np.minimum(np.maximum(mnx, 0), max(img_w - win, 0))
    y_org = np.minimum(np.maximum(mny, 0), max(img_h - win, 0))
    xlo, ylo = np.maximum(mnx, x_org), np.maximum(mny, y_org)
    xhi = np.minimum(np.minimum(mxx, x_org + win - 1), img_w - 1)
    yhi = np.minimum(np.minimum(mxy, y_org + win - 1), img_h - 1)
    busy = v & (xlo <= xhi) & (ylo <= yhi)
    bw = np.where(busy, xhi - xlo + 1, 0)
    npx = np.where(busy, bw * (yhi - ylo + 1), 0)
    # every box pixel of every tile, in the walk's order
    slot_px, r_px = [], []
    for t0 in range(0, n_slots, tile):
        n = npx[t0:t0 + tile]
        boxes = np.nonzero(n)[0]                   # the compact list
        if len(boxes) == 0:
            continue
        start = np.concatenate([[0], np.cumsum(n[boxes])])
        p, _ = walk_order(int(start[-1]))
        assert np.array_equal(np.sort(p), np.arange(start[-1]))
        b = np.searchsorted(start, p, side='right') - 1   # the lane's box
        slot_px.append(t0 + boxes[b])
        r_px.append(p - start[b])
    total = np.zeros(n_slots, np.int64)
    count = np.zeros(n_slots, np.int64)
    if slot_px:
        s = np.concatenate(slot_px)
        r = np.concatenate(r_px)
        px = xlo[s] + r % bw[s]
        py = ylo[s] + r // bw[s]
        x = qx[s].astype(np.uint32)
        y = qy[s].astype(np.uint32)
        area2 = sum(_wrap32(_wrap32(qx[s, i].astype(np.int64) *
                                    qy[s, (i + 1) % 4]).astype(np.int64) -
                            _wrap32(qx[s, (i + 1) % 4].astype(np.int64) *
                                    qy[s, i])).astype(np.int64)
                    for i in range(4))
        positive = area2 >= 0
        c = []
        for i in range(4):
            k = (i + 1) % 4
            ex, ney = x[:, k] - x[:, i], y[:, i] - y[:, k]
            kk = x[:, i] * (np.uint32(0) - ney) - ex * y[:, i]
            c.append((ex * py.astype(np.uint32) + ney * px.astype(np.uint32)
                      + kk).astype(np.int32))
        c = np.stack(c, 1)
        member = np.where(positive, c.min(1) >= 0, c.max(1) <= 0)
        sane = ((np.abs(qx[s].astype(np.int64)) <= 1 << 13) &
                (np.abs(qy[s].astype(np.int64)) <= 1 << 13)).all(1)
        closed = np.zeros(len(s), bool)
        slow = np.zeros(len(s), bool)
        for i in range(4):
            k = (i + 1) % 4
            lo, length, x_major, sign = _edge_params(
                qx[s, i], qy[s, i], qx[s, k], qy[s, k])
            u = (np.where(x_major, px, py) - lo).astype(np.uint32)
            band = (2 * sign * c[:, i].astype(np.int64) + length - 1)
            closed |= (u <= length.astype(np.uint32)) & \
                (band.astype(np.uint32) <= (2 * length - 1).astype(np.uint32))
            slow |= _on_edge(qx[s, i, None], qy[s, i, None], qx[s, k, None],
                             qy[s, k, None], px[:, None], py[:, None])[:, 0]
        # the closed form is the remainder tests wherever it is taken
        np.testing.assert_array_equal(closed[sane & ~member],
                                      slow[sane & ~member])
        member |= np.where(sane, closed, slow)
        flat = gray.reshape(t, -1).astype(np.int64)
        g = flat[s // d, py * img_w + px]
        np.add.at(total, s[member], g[member])
        np.add.at(count, s[member], 1)
    total32 = _wrap32(total)
    mean = total32.astype(np.float32) / np.maximum(count, 1).astype(
        np.float32)
    out = np.where(count > 0, mean * np.float32(0.01), np.float32(0))
    return out.astype(np.float32).reshape(valid.shape)


@pytest.mark.parametrize('tile', [256, 64, 32, 5])
@pytest.mark.parametrize('case', RECT_CASES)
def test_kernel_design_matches_plain(case, tile):
    """The kernel's design, emulated in numpy at its tiles of 256, 64 and
    32 slots and at 5, bit-equal to the plain version on every case, the
    10^4 uniform random and 10^4 ``cv2.minAreaRect`` rects and the
    wrapping corners included: the bounding-box walk holds every member of
    the window, the warps' passes visit each box pixel once, the cross
    products wrap as the plain version's, and the closed-form and
    remainder edge tests are the floor divisions."""
    gray, params, valid, win = rect_case(case)
    with np.errstate(over='ignore'):
        got = kernel_emulation(gray, params, valid, win, tile=tile)
    np.testing.assert_array_equal(got, _plain(gray, params, valid, win))


def test_walk_visits_each_box_pixel_once():
    """The warps' ranges of passes visit each pixel of a tile's flat list
    once, for lists of 0 to 3000 pixels; a lane's box pixel found anew (r
    // bw, r % bw) and then stepped (32 // bw rows and 32 % bw columns a
    pass, one carry) is the raster numbering of the box, for every width
    up to 69 and every starting pixel."""
    for pixels in list(range(0, 70)) + [255, 256, 257, 1000, 2999, 3000]:
        p, wp = walk_order(pixels)
        np.testing.assert_array_equal(np.sort(p), np.arange(pixels))
        assert (np.diff(wp) >= 0).all()
    for bw in range(1, 70):
        for bh in (1, 2, 5):
            n = bw * bh
            for r0 in range(0, n, max(1, n // 7)):
                steps = np.arange((n - 1 - r0) // 32 + 1)
                x, y = r0 % bw, r0 // bw
                xs, ys = [x], [y]
                for _ in steps[1:]:
                    x, y = x + 32 % bw, y + 32 // bw
                    if x >= bw:
                        x, y = x - bw, y + 1
                    xs.append(x)
                    ys.append(y)
                np.testing.assert_array_equal(
                    np.array(ys) * bw + np.array(xs), r0 + 32 * steps)


def test_wrapper_routes_and_refusals():
    """A CPU tensor goes to the plain version (bit-equal, no launch); any
    other device than the CPU and CUDA raises, and so do the card's
    refusals before they reach the card."""
    gray, params, valid, win = rect_case('win32')
    args = [torch.from_numpy(gray)] + [torch.from_numpy(p) for p in params] \
        + [torch.from_numpy(valid)]
    n = lum.rect_mean_luminosity.launches
    np.testing.assert_array_equal(
        lum.rect_mean_luminosity(*args, win=win).numpy(),
        _plain(gray, params, valid, win))
    assert lum.rect_mean_luminosity.launches == n
    with pytest.raises(ValueError, match='unsupported device'):
        lum.rect_mean_luminosity(*(a.to('meta') for a in args), win=win)
