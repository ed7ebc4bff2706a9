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

from lum_cases import RECT_CASES, rect_case
from ysmr_tpu.ops import luminosity as jlum
from ysmr_tpu_torch.ops import luminosity as lum

torch.set_num_threads(1)

#: the cases whose window fits the frame (JAX's dynamic_slice needs it)
JAX_CASES = tuple(c for c in RECT_CASES
                  if c not in ('small_frame', 'random', 'min_area'))


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


def kernel_emulation(gray, params, valid, win, chunk=256):
    """``csrc/luminosity.cu``'s design: per slot the corners and the walk
    box (the quad's bounding box clipped to the window and the frame); the
    box's pixels dealt to 32 lanes, 32 consecutive pixels a pass, each
    lane's (x, y) advanced by the pass's 32 // bw rows and 32 % bw columns
    with one carry; the cross products, then the edges where they fail;
    each lane's int32 sum and count, then the warp's sums."""
    t, img_h, img_w = gray.shape
    qx, qy = _corners(params)
    v = valid.reshape(-1)
    n_slots = len(v)
    mnx, mxx = qx.min(1).astype(np.int64), qx.max(1).astype(np.int64)
    mny, mxy = qy.min(1).astype(np.int64), qy.max(1).astype(np.int64)
    x_org = np.minimum(np.maximum(mnx, 0), max(img_w - win, 0))
    y_org = np.minimum(np.maximum(mny, 0), max(img_h - win, 0))
    xlo, ylo = np.maximum(mnx, x_org), np.maximum(mny, y_org)
    xhi = np.minimum(np.minimum(mxx, x_org + win - 1), img_w - 1)
    yhi = np.minimum(np.minimum(mxy, y_org + win - 1), img_h - 1)
    busy = v & (xlo <= xhi) & (ylo <= yhi)
    bw = np.where(busy, xhi - xlo + 1, 1)
    npx = np.where(busy, bw * (yhi - ylo + 1), 0)
    total = np.zeros(n_slots, np.int64)
    count = np.zeros(n_slots, np.int64)
    flat = gray.reshape(t, -1).astype(np.int64)
    d = params[0].shape[1]
    for s0 in range(0, n_slots, chunk):
        sl = slice(s0, min(s0 + chunk, n_slots))
        p_max = int(npx[sl].max()) if npx[sl].size else 0
        if p_max == 0:
            continue
        p_max = -(-p_max // 32) * 32
        idx = np.arange(p_max)[None, :]
        lane, step = idx % 32, idx // 32
        b = bw[sl, None]
        r = lane % b + step * (32 % b)
        px = xlo[sl, None] + r % b
        py = ylo[sl, None] + lane // b + step * (32 // b) + r // b
        inside = idx < npx[sl, None]
        x = qx[sl].astype(np.int64)
        y = qy[sl].astype(np.int64)
        area2 = sum(_wrap32(_wrap32(x[:, i] * y[:, (i + 1) % 4]).astype(
            np.int64) - _wrap32(x[:, (i + 1) % 4] * y[:, i]))
            .astype(np.int64) for i in range(4))
        positive = (area2 >= 0)[:, None]
        member = np.ones(px.shape, bool)
        for i in range(4):
            k = (i + 1) % 4
            ex = _wrap32(x[:, k] - x[:, i]).astype(np.int64)[:, None]
            ey = _wrap32(y[:, k] - y[:, i]).astype(np.int64)[:, None]
            cross = _wrap32(_wrap32(ex * (py - y[:, i, None])).astype(
                np.int64) - _wrap32(ey * (px - x[:, i, None])))
            member &= np.where(positive, cross >= 0, cross <= 0)
        edges = np.zeros(px.shape, bool)
        for i in range(4):
            k = (i + 1) % 4
            edges |= _on_edge(qx[sl, i, None], qy[sl, i, None],
                              qx[sl, k, None], qy[sl, k, None], px, py)
        member = inside & (member | edges)
        frame = (np.arange(n_slots)[sl] // d)[:, None]
        g = flat[frame, np.clip(py, 0, img_h - 1) * img_w +
                 np.clip(px, 0, img_w - 1)]
        lanes_sum = np.where(member, g, 0).reshape(len(b), -1, 32).sum(1)
        lanes_cnt = member.reshape(len(b), -1, 32).sum(1)
        total[sl] = lanes_sum.sum(1)
        count[sl] = lanes_cnt.sum(1)
    total32 = _wrap32(total)
    mean = total32.astype(np.float32) / np.maximum(count, 1).astype(
        np.float32)
    out = np.where(count > 0, mean * np.float32(0.01), np.float32(0))
    return out.astype(np.float32).reshape(valid.shape)


@pytest.mark.parametrize('case', RECT_CASES)
def test_kernel_design_matches_plain(case):
    """The kernel's design, emulated in numpy, bit-equal to the plain
    version on every case, the 10^4 uniform random and 10^4
    ``cv2.minAreaRect`` rects included: the bounding-box walk holds every
    member of the window, the lanes' steps visit each box pixel once, and
    the remainder tests are the floor divisions."""
    gray, params, valid, win = rect_case(case)
    with np.errstate(over='ignore'):
        got = kernel_emulation(gray, params, valid, win)
    np.testing.assert_array_equal(got, _plain(gray, params, valid, win))


def test_walk_visits_each_box_pixel_once():
    """The lanes' stepping (32 // bw rows and 32 % bw columns a pass, one
    carry) is the raster numbering of the box, for every width up to 64
    and past 32."""
    for bw in range(1, 70):
        for bh in (1, 2, 5):
            n = bw * bh
            idx = np.arange(-(-n // 32) * 32)
            lane, step = idx % 32, idx // 32
            r = lane % bw + step * (32 % bw)
            x = r % bw
            y = lane // bw + step * (32 // bw) + r // bw
            np.testing.assert_array_equal((y * bw + x)[idx < n],
                                          np.arange(n))


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
