"""Wrappers of the hand-written CUDA kernels of the exact rect's tail.

``csrc/rect.cu`` holds two kernels, each one launch a call; its source
notes the design and what bounds it:

- ``edge_finish``: the fold, fdlibm angle and validity of both hull chains'
  edge vectors (``ysmr_tpu/ops/labeling.py::_edge_vector_finish``, called
  twice by ``_hull_edge_data``); plain version
  ``ops/labeling.py::edge_finish_plain``;
- ``rect_select``: the minimum-area choice among the swept candidates and
  the rect it gives (``ysmr_tpu/ops/labeling.py::_min_area_rect_exact``
  after the sweep); plain version ``ops/labeling.py::rect_select_plain``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.labeling import edge_finish_plain, rect_select_plain

_F32 = torch.float32


def _check(what, tensors, shape, dtypes, dev):
    for (name, a), dtype in zip(tensors, dtypes):
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype or \
                a.device != dev or not a.is_contiguous():
            raise ValueError('{}: {} must be a contiguous {} {} tensor on '
                             '{}'.format(what, name, tuple(shape), dtype,
                                         dev))


def edge_finish(dx_l, dy_l, edge_l, dx_r, dy_r, edge_r):
    """Folded edge vectors, angles and validity of both hull chains
    (contract of ``labeling.edge_finish_plain``).

    :param dx_l, dy_l, dx_r, dy_r: (D, R) float32 outgoing edge vectors of
        the left and right chains; edge_l, edge_r (D, R) bool edge flags
    :return: (dx, dy, angles, valid), (D, 2 (R - 1)): the left chain's
        R - 1 slots, then the right chain's
    """
    dev = dx_l.device
    if dev.type == 'cpu':
        return edge_finish_plain(dx_l, dy_l, edge_l, dx_r, dy_r, edge_r)
    if dev.type != 'cuda':
        raise ValueError('edge_finish: unsupported device {}'.format(dev))
    if dx_l.dim() != 2 or dx_l.shape[1] < 1:
        raise ValueError('edge_finish: the chains must be (D, R), R >= 1')
    d, r = dx_l.shape
    _check('edge_finish', (('dx_l', dx_l), ('dy_l', dy_l),
                           ('edge_l', edge_l), ('dx_r', dx_r),
                           ('dy_r', dy_r), ('edge_r', edge_r)),
           (d, r), (_F32, _F32, torch.bool) * 2, dev)
    outs = [torch.empty((d, 2 * (r - 1)), dtype=dt, device=dev)
            for dt in (_F32, _F32, _F32, torch.bool)]
    if outs[0].numel():
        lib = _build.load_kernels()
        rc = lib.ysmr_edge_finish(
            dx_l.data_ptr(), dy_l.data_ptr(), edge_l.data_ptr(),
            dx_r.data_ptr(), dy_r.data_ptr(), edge_r.data_ptr(),
            *(o.data_ptr() for o in outs), d, r, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, 'edge finish kernel launch')
        edge_finish.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
edge_finish.launches = 0


def rect_select(min_u, max_u, min_v, max_v, edge_dx, edge_dy, edge_angles,
                edge_valid):
    """The exact minimum-area rect from the swept candidates (contract of
    ``labeling.rect_select_plain``).

    :param min_u, max_u, min_v, max_v: (D, K) float32 extents from
        ``sweep_extents``, the horizontal candidate (1, 0) last
    :param edge_dx, edge_dy, edge_angles: (D, K - 1) float32; edge_valid
        (D, K - 1) bool, of the hull candidates (the appended (1, 0) has
        angle 0, is valid and is formed by the kernel)
    :return: (cx, cy, w, h, angle_deg), each (D,) float32
    """
    dev = min_u.device
    if dev.type == 'cpu':
        return rect_select_plain(min_u, max_u, min_v, max_v, edge_dx,
                                 edge_dy, edge_angles, edge_valid)
    if dev.type != 'cuda':
        raise ValueError('rect_select: unsupported device {}'.format(dev))
    if min_u.dim() != 2 or min_u.shape[1] < 1:
        raise ValueError('rect_select: the extents must be (D, K), K >= 1')
    d, k = min_u.shape
    _check('rect_select', (('min_u', min_u), ('max_u', max_u),
                           ('min_v', min_v), ('max_v', max_v)),
           (d, k), (_F32,) * 4, dev)
    _check('rect_select', (('edge_dx', edge_dx), ('edge_dy', edge_dy),
                           ('edge_angles', edge_angles),
                           ('edge_valid', edge_valid)), (d, k - 1),
           (_F32, _F32, _F32, torch.bool), dev)
    outs = [torch.empty(d, dtype=_F32, device=dev) for _ in range(5)]
    if d:
        lib = _build.load_kernels()
        rc = lib.ysmr_rect_select(
            min_u.data_ptr(), max_u.data_ptr(), min_v.data_ptr(),
            max_v.data_ptr(), edge_dx.data_ptr(), edge_dy.data_ptr(),
            edge_angles.data_ptr(), edge_valid.data_ptr(),
            *(o.data_ptr() for o in outs), d, k, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, 'rect select kernel launch')
        rect_select.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
rect_select.launches = 0
