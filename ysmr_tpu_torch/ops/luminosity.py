"""Reference-exact rotated-rectangle luminosity (the ILLUMINATION column).

Counterpart of ``ysmr_tpu/ops/luminosity.py``, whose docstring sets out the
recipe: the reference takes, per detection, the mean gray value over the
filled rotated rectangle (``np.intp(cv2.boxPoints(rect))``,
``cv2.fillPoly``, ``cv2.mean(gray, mask) / 100``). The pixel set is the
inclusive point-in-quad test united with the four edges drawn as LINE_8
lines, all in exact integer arithmetic, evaluated over a ``win x win``
window per detection.

On a CUDA tensor ``rect_mean_luminosity`` is one launch of the
hand-written kernel ``csrc/luminosity.cu`` over all T x D slots of a batch
(a block a tile of slots: their corners, then the tile's box pixels, each
quad's bounding box clipped to the window, walked as one flat list by all
its warps; no host synchronisation); on a CPU tensor
``rect_mean_luminosity_plain``, the torch sequence. The kernel and the
plain version give the same bits.

Differences from the JAX module:

- Batched over all detections of a batch at once ((T, H, W) frames, (T, D)
  rects) instead of ``vmap``. The plain version runs the (N, win, win)
  window tensors in chunks of the valid detections, so its temporaries
  stay small at dense capacities (64 x 4096 windows of 48 x 48 int32 would
  be 2.4 GB each); the kernel keeps no window.
- The corners follow OpenCV 4's ``RotatedRect::points`` operation for
  operation: the angle in radians, ``cos`` and ``sin`` in float64, rounded
  to float32 and halved, the float32 corner sums unfused, corners 2 and 3
  mirrored through the center. That gives the same bits on the CPU and on
  CUDA. The JAX function takes a float32 angle and XLA:CPU's float32
  ``cos``/``sin``, which are not correctly rounded, and XLA may contract
  the sums into fmas depending on the surrounding program. A truncated
  corner sits on a knife edge often in real rects (half-pixel centers,
  sides and angles of small integer edge vectors): over 2 x 10^4
  ``cv2.minAreaRect`` rects the corners differ from the jitted JAX
  function's on 79 and from OpenCV 5's ``boxPoints`` (which computes
  corners 2 and 3 on their own) on 54; pinned in
  tests/test_torch_luminosity.py.
- ``mean / 100`` is the product with float32(0.01), as XLA compiles the
  JAX division by the constant.
"""

import math

import numpy as np
import torch

from ysmr_tpu_torch import _build

_I32 = torch.int32
_F32 = torch.float32
#: float32(0.01): XLA rewrites ``mean / 100.0`` as a product with it
HUNDREDTH = float(np.float32(0.01))
#: window pixels per chunk of detections of the plain version
_CHUNK_ELEMS = 1 << 24


def box_points_int(cx, cy, w, h, angle_deg):
    """Integer (truncated toward zero) corners of rotated rects, like
    ``np.intp(cv2.boxPoints(((cx, cy), (w, h), angle)))``.

    :param cx, cy, w, h, angle_deg: (N,) float32
    :return: (N, 4, 2) int32 corners [x, y]
    """
    a = angle_deg.double() * math.pi / 180.0
    b = torch.cos(a).to(_F32) * 0.5
    s = torch.sin(a).to(_F32) * 0.5
    x0 = cx - s * h - b * w
    y0 = cy + b * h - s * w
    x1 = cx + s * h - b * w
    y1 = cy - b * h - s * w
    xs = torch.stack([x0, x1, 2.0 * cx - x0, 2.0 * cx - x1], dim=-1)
    ys = torch.stack([y0, y1, 2.0 * cy - y0, 2.0 * cy - y1], dim=-1)
    return torch.stack([torch.trunc(xs), torch.trunc(ys)], dim=-1).to(_I32)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode='floor')


def _edge_line_membership(px, py, x0, y0, x1, y1):
    """Membership of pixels (px, py) on the LINE_8 segment (x0, y0)-(x1, y1):
    the closed form of OpenCV's LineIterator. Endpoints broadcast against
    the pixels."""
    swap = (x1 < x0) | ((x1 == x0) & (y1 < y0))
    ax0 = torch.where(swap, x1, x0)
    ay0 = torch.where(swap, y1, y0)
    ax1 = torch.where(swap, x0, x1)
    ay1 = torch.where(swap, y0, y1)
    dx = ax1 - ax0
    dy = ay1 - ay0
    sy = torch.where(dy >= 0, 1, -1)
    adx = dx.abs()          # dx >= 0 after the lexicographic swap
    ady = dy.abs()
    x_major = adx >= ady
    # x-major: k = px - ax0; y offset = (2k*ady + adx - 1) // (2*adx)
    kx = px - ax0
    qx = torch.where(adx > 0, _floor_div(2 * kx * ady + adx - 1,
                                         torch.clamp(2 * adx, min=1)), 0)
    on_x = (kx >= 0) & (kx <= adx) & ((py - ay0) * sy == qx)
    # y-major: k = (py - ay0) * sy; x offset = (2k*adx + ady - 1) // (2*ady)
    ky = (py - ay0) * sy
    qy = torch.where(ady > 0, _floor_div(2 * ky * adx + ady - 1,
                                         torch.clamp(2 * ady, min=1)), 0)
    on_y = (ky >= 0) & (ky <= ady) & ((px - ax0) == qy)
    point = (adx == 0) & (ady == 0)
    return torch.where(point, (px == ax0) & (py == ay0),
                       torch.where(x_major, on_x, on_y))


def fill_poly_membership(quad, px, py):
    """``cv2.fillPoly`` membership of integer quads at pixels (px, py).

    :param quad: (N, 4, 2) int32 corners
    :param px, py: int32 pixel coordinates broadcastable against (N, 1, 1)
        (for example (N, 1, win) and (N, win, 1))
    :return: bool membership of the broadcast shape
    """
    qx = quad[..., 0][:, :, None, None]          # (N, 4, 1, 1)
    qy = quad[..., 1][:, :, None, None]
    qx_n = torch.roll(quad[..., 0], -1, dims=1)
    qy_n = torch.roll(quad[..., 1], -1, dims=1)
    area2 = (quad[..., 0] * qy_n - qx_n * quad[..., 1]).sum(dim=1)
    sign = torch.where(area2 >= 0, 1, -1)[:, None, None]
    member = (px >= qx.amin(dim=1)) & (px <= qx.amax(dim=1)) & \
        (py >= qy.amin(dim=1)) & (py <= qy.amax(dim=1))
    for i in range(4):
        j = (i + 1) % 4
        x1, y1 = qx[:, i], qy[:, i]
        x2, y2 = qx[:, j], qy[:, j]
        cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        member = member & (sign * cross >= 0)
    for i in range(4):
        j = (i + 1) % 4
        member = member | _edge_line_membership(px, py, qx[:, i], qy[:, i],
                                                qx[:, j], qy[:, j])
    return member


def _window_sums(gray, cx, cy, w, h, angle_deg, valid, *, win):
    """The plain version's per-slot int32 gray sum and member count over
    each valid detection's window, in chunks of the valid detections:
    two flat (T*D,) int32 (0 for invalid slots)."""
    t, img_h, img_w = gray.shape
    d = cx.shape[1]
    dev = gray.device
    total_out = torch.zeros((t * d,), dtype=_I32, device=dev)
    count_out = torch.zeros((t * d,), dtype=_I32, device=dev)
    sel = torch.nonzero(valid.reshape(-1)).flatten()
    flat_gray = gray.reshape(-1)
    iota = torch.arange(win, dtype=_I32, device=dev)
    params = [a.reshape(-1) for a in (cx, cy, w, h, angle_deg)]
    step = max(1, _CHUNK_ELEMS // (win * win))
    for s in range(0, sel.numel(), step):
        idx = sel[s:s + step]
        quad = box_points_int(*(p[idx] for p in params))
        x_org = torch.clamp(quad[..., 0].amin(dim=1), 0, max(img_w - win, 0))
        y_org = torch.clamp(quad[..., 1].amin(dim=1), 0, max(img_h - win, 0))
        px = x_org[:, None, None] + iota[None, None, :]      # (n, 1, win)
        py = y_org[:, None, None] + iota[None, :, None]      # (n, win, 1)
        member = fill_poly_membership(quad, px, py) & (px < img_w) & \
            (py < img_h)
        frame = torch.div(idx, d, rounding_mode='floor')
        pix = (frame[:, None, None] * (img_h * img_w) +
               torch.clamp(py, max=img_h - 1).long() * img_w +
               torch.clamp(px, max=img_w - 1).long())
        vals = flat_gray[pix].to(_I32)
        total_out[idx] = torch.where(member, vals, 0).sum(dim=(1, 2),
                                                          dtype=_I32)
        count_out[idx] = member.sum(dim=(1, 2), dtype=_I32)
    return total_out, count_out


def rect_mean_luminosity_plain(gray, cx, cy, w, h, angle_deg, valid, *,
                               win=48):
    """Plain version of ``rect_mean_luminosity``: the torch sequence over
    (n, win, win) windows in chunks of the valid detections (one
    ``torch.nonzero`` of ``valid`` first)."""
    t, d = cx.shape
    total, count = _window_sums(gray, cx, cy, w, h, angle_deg, valid,
                                win=win)
    mean = total.to(_F32) / torch.clamp(count, min=1).to(_F32)
    return torch.where(count > 0, mean * HUNDREDTH,
                       torch.zeros_like(mean)).view(t, d)


def rect_mean_luminosity(gray, cx, cy, w, h, angle_deg, valid, *, win=48):
    """Mean gray over each detection's filled rotated rectangle, / 100.

    On a CUDA tensor one launch of ``csrc/luminosity.cu`` over every slot
    (an invalid one gives 0; no host synchronisation); it takes contiguous
    tensors, the gray frames as uint8 (the pixels-mode upload) or int32
    (frames mode's preprocess), and a window of fewer than 2^30 pixels
    inside the frame, and raises on anything else. On a CPU tensor
    ``rect_mean_luminosity_plain``, which takes any integer gray and
    window.

    :param gray: (T, H, W) integer grayscale frames
    :param cx, cy, w, h, angle_deg: (T, D) float32 rect parameters
    :param valid: (T, D) bool
    :param win: the window's side (``luminosity window size``), >= 1
    :return: (T, D) float32 luminosity (0 for invalid detections)
    """
    if gray.device.type == 'cpu':
        return rect_mean_luminosity_plain(gray, cx, cy, w, h, angle_deg,
                                          valid, win=win)
    name = 'rect_mean_luminosity'
    if gray.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, gray.device))
    if gray.dim() != 3 or gray.dtype not in (torch.uint8, _I32) or \
            not gray.is_contiguous():
        raise ValueError('{}: gray must be contiguous (T, H, W) uint8 or '
                         'int32'.format(name))
    t, img_h, img_w = gray.shape
    if cx.dim() != 2 or cx.shape[0] != t:
        raise ValueError('{}: rects must be (T, D) with the frames\' '
                         'T'.format(name))
    for a, dt in ((cx, _F32), (cy, _F32), (w, _F32), (h, _F32),
                  (angle_deg, _F32), (valid, torch.bool)):
        if a.shape != cx.shape or a.dtype != dt or a.device != gray.device \
                or not a.is_contiguous():
            raise ValueError('{}: expects contiguous (T, D) float32 cx, cy, '
                             'w, h, angle_deg and bool valid on {}'.format(
                                 name, gray.device))
    if int(win) < 1:
        raise ValueError('{}: win must be at least 1'.format(name))
    if min(int(win), img_w) * min(int(win), img_h) >= 1 << 30:
        raise ValueError('{}: a window of 2^30 pixels or more inside the '
                         'frame'.format(name))
    d = cx.shape[1]
    out = torch.empty((t, d), dtype=_F32, device=gray.device)
    lib = _build.load_kernels()
    rc = lib.ysmr_rect_mean_lum(
        gray.data_ptr(), gray.element_size(), cx.data_ptr(), cy.data_ptr(),
        w.data_ptr(), h.data_ptr(), angle_deg.data_ptr(), valid.data_ptr(),
        out.data_ptr(), t, d, img_h, img_w, int(win), gray.device.index,
        torch.cuda.current_stream(gray.device).cuda_stream)
    _build.check(lib, rc, 'rect mean kernel launch')
    rect_mean_luminosity.launches += 1
    return out


#: kernel launches since the count was last set to 0
rect_mean_luminosity.launches = 0
