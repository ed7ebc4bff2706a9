"""Rotated-rect luminosity of the PyTorch port (ysmr_tpu_torch/ops/
luminosity.py) against the jitted JAX functions and cv2 on the same numpy
rects and frames.

The corners follow OpenCV 4's ``RotatedRect::points`` (float64 angle and
cos/sin rounded to float32); the JAX function takes a float32 angle and
XLA:CPU's float32 cos/sin, which are not correctly rounded, and OpenCV 5
computes two of the corners another way. So an integer corner differs on
a knife edge now and then: the counts against JAX and against cv2 are
pinned. Where the corners agree, everything after them is integer
arithmetic and one float32 division and product, so the means are
bit-equal; against cv2's float64 mean they agree within 1e-6.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import luminosity as jlum
from ysmr_tpu_torch.ops import luminosity as lum

torch.set_num_threads(1)

H, W = 120, 160


def _rects(rng, n, margin=25.0, max_side=16.0):
    """float32 rect parameters; the angles of cv2's (-90, 0] convention
    with the exact ends, then any angle."""
    cx = rng.uniform(margin, W - margin, n).astype(np.float32)
    cy = rng.uniform(margin, H - margin, n).astype(np.float32)
    w = rng.uniform(0.5, max_side, n).astype(np.float32)
    h = rng.uniform(0.5, max_side, n).astype(np.float32)
    ang = rng.uniform(-90, 0, n).astype(np.float32)
    ang[: n // 20] = -90.0
    ang[n // 20: n // 10] = 0.0
    ang[-n // 10:] = rng.uniform(-180, 180, n // 10)
    # half-pixel centers and sides of integer edge vectors, as real rects
    q = n // 5
    cx[q:2 * q] = np.round(cx[q:2 * q] * 2) / 2
    cy[q:2 * q] = np.round(cy[q:2 * q] * 2) / 2
    return cx, cy, w, h, ang


def _cv2_lum(gray, cx, cy, w, h, ang):
    box = np.intp(cv2.boxPoints(((cx, cy), (w, h), ang)))
    mask = np.zeros(gray.shape, np.uint8)
    cv2.fillPoly(mask, [box], 255)
    return cv2.mean(gray, mask)[0] / 100.0


def _min_area_rects(seed, n):
    """cv2.minAreaRect of n random ellipse blobs (the rects the host-rect
    path measures): half-pixel centers, sides and angles of small integer
    edge vectors, where a truncated corner often sits on a knife edge."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((48, 48), np.uint8)
        cv2.ellipse(img, (int(rng.integers(16, 32)), int(rng.integers(16, 32))),
                    (int(rng.integers(1, 12)), int(rng.integers(1, 5))),
                    float(rng.uniform(0, 180)), 0, 360, 255, -1)
        cnts, _ = cv2.findContours(img, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
        (cx, cy), (w, h), a = cv2.minAreaRect(cnts[0])
        out.append((cx + rng.integers(0, 100), cy + rng.integers(0, 60), w,
                    h, a))
    return [np.array(c, np.float32) for c in zip(*out)]


def _opencv4_corners(cx, cy, w, h, ang):
    """OpenCV 4's RotatedRect::points in numpy: float64 angle and cos/sin,
    rounded to float32, float32 corner sums, corners 2 and 3 mirrored
    through the center; truncated."""
    a64 = ang.astype(np.float64) * np.pi / 180.0
    b = np.cos(a64).astype(np.float32) * np.float32(0.5)
    s = np.sin(a64).astype(np.float32) * np.float32(0.5)
    x0, y0 = cx - s * h - b * w, cy + b * h - s * w
    x1, y1 = cx + s * h - b * w, cy - b * h - s * w
    two = np.float32(2)
    xs = np.stack([x0, x1, two * cx - x0, two * cx - x1], 1)
    ys = np.stack([y0, y1, two * cy - y0, two * cy - y1], 1)
    return np.stack([np.trunc(xs), np.trunc(ys)], 2).astype(np.int32)


def _n_differ(a, b):
    """Rects whose corner sets differ ((N, 4, 2) int32 each)."""
    n = len(a)
    return int((np.sort(a.view(np.int64).reshape(n, 4), 1) !=
                np.sort(b.view(np.int64).reshape(n, 4), 1)).any(axis=1).sum())


@pytest.mark.parametrize('kind', ['uniform', 'min_area_rect'])
def test_box_points_int_against_jax_and_cv2(kind):
    """10^5 uniform random rects and 2 x 10^4 cv2.minAreaRect rects.
    Pinned corner-set differences: none from OpenCV 4's formula; from the
    jitted JAX function none on the uniform rects and 79 on the
    minAreaRect ones (its float32 angle and cos/sin); from the installed
    cv2.boxPoints none (OpenCV 4) or, under OpenCV 5, which computes
    corners 2 and 3 on their own instead of mirroring them, 54 of the
    minAreaRect rects."""
    r = _rects(np.random.default_rng(0), 100000) if kind == 'uniform' \
        else _min_area_rects(2, 20000)
    ours = lum.box_points_int(*(torch.from_numpy(a) for a in r)).numpy()
    assert ours.shape == (len(r[0]), 4, 2) and ours.dtype == np.int32
    assert _n_differ(ours, _opencv4_corners(*r)) == 0
    jax_q = np.asarray(jax.jit(jax.vmap(jlum.box_points_int))(*r))
    cv2_q = np.stack([np.intp(cv2.boxPoints(((r[0][i], r[1][i]),
                                             (r[2][i], r[3][i]), r[4][i])))
                      for i in range(len(r[0]))]).astype(np.int32)
    cv2_major = int(cv2.__version__.split('.')[0])
    want_cv2 = 54 if kind == 'min_area_rect' and cv2_major >= 5 else 0
    assert (_n_differ(ours, jax_q), _n_differ(ours, cv2_q)) == \
        (0 if kind == 'uniform' else 79, want_cv2)


def test_rect_mean_luminosity_matches_jax_and_cv2():
    """10^4 rects over 4 frames (a tenth of them near or past the frame
    border): bit-equal to the jitted JAX function wherever the corners
    agree, and within 1e-6 of cv2's recipe on the interior rects."""
    rng = np.random.default_rng(1)
    t, d = 4, 2500
    gray = rng.integers(0, 256, (t, H, W), dtype=np.uint8)
    params = [np.stack(p) for p in zip(*(_rects(rng, d) for _ in range(t)))]
    edge = np.zeros((t, d), bool)
    edge[:, :d // 10] = True
    params[0][edge] = rng.uniform(-4, W + 4, edge.sum()).astype(np.float32)
    valid = rng.random((t, d)) < 0.95
    ours = lum.rect_mean_luminosity(
        torch.from_numpy(gray), *(torch.from_numpy(p) for p in params),
        torch.from_numpy(valid), win=48).numpy()
    assert ours.dtype == np.float32 and ours.shape == (t, d)
    jfn = jax.jit(jlum.rect_mean_luminosity, static_argnames=('win',))
    ref = np.stack([np.asarray(jfn(gray[i].astype(np.int32),
                                   *(p[i] for p in params), valid[i],
                                   win=48)) for i in range(t)])
    quads = lum.box_points_int(*(torch.from_numpy(p.reshape(-1))
                                 for p in params)).numpy()
    jquads = np.asarray(jax.jit(jax.vmap(jlum.box_points_int))(
        *(p.reshape(-1) for p in params)))
    same = (np.sort(quads.view(np.int64).reshape(-1, 4), 1) ==
            np.sort(jquads.view(np.int64).reshape(-1, 4), 1)).all(axis=1)
    same = same.reshape(t, d)
    np.testing.assert_array_equal(ours[same], ref[same])
    assert (~same).sum() == 0 or (ours[~same] != ref[~same]).any()
    assert (ours[~valid] == 0).all() and (ours[valid & ~edge] > 0).all()
    for i in range(t):
        for k in np.nonzero(valid[i] & ~edge[i])[0][:400]:
            want = _cv2_lum(gray[i], *(p[i, k] for p in params))
            assert abs(float(ours[i, k]) - want) <= 1e-6, (i, k)


def test_rect_mean_luminosity_chunks_and_degenerate(monkeypatch):
    """Chunking the windows changes nothing; a zero-size rect covers its
    one pixel (fillPoly draws it) and an invalid one gives 0, as in JAX."""
    gray = np.full((1, 40, 40), 150, np.uint8)
    gray[0, 10:30, 10:30] = 90
    r = [np.array([[20.0, 20.0, 12.5]], np.float32),
         np.array([[20.0, 20.0, 15.0]], np.float32),
         np.array([[0.0, 4.0, 7.0]], np.float32),
         np.array([[0.0, 2.0, 3.0]], np.float32),
         np.array([[0.0, 0.0, -30.0]], np.float32)]
    valid = np.array([[True, False, True]])
    args = [torch.from_numpy(a) for a in [gray] + r + [valid]]
    whole = lum.rect_mean_luminosity(*args, win=32).numpy()
    assert whole[0, 0] == pytest.approx(0.9) and whole[0, 1] == 0.0
    monkeypatch.setattr(lum, '_CHUNK_ELEMS', 32 * 32)
    np.testing.assert_array_equal(
        lum.rect_mean_luminosity(*args, win=32).numpy(), whole)
    ref = jax.jit(jlum.rect_mean_luminosity, static_argnames=('win',))(
        gray[0].astype(np.int32), *(a[0] for a in r), valid[0], win=32)
    np.testing.assert_array_equal(whole[0], np.asarray(ref))
