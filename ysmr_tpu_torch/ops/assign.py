"""Wrapper of the hand-written CUDA kernel for the per-row nearest
detection of the tracker.

Counterpart of ``ysmr_tpu/ops/pallas_assign.py::row_min_argmin``. The
kernel (``csrc/assign.cu``) is one launch: a block per tile of 16 tracker
rows, the columns split over its threads, the partial minima merged as
(distance bits, column) keys; its source notes the design, the
distance's rounding order and what bounds it. The plain PyTorch version
is ``ops/assignment.py::row_min_argmin_plain``. A leading video axis
(``(V, R, K)``, the multi-video tracker's) is the kernel grid's second
dimension: one launch for all V problems, each with the bits of its own
unbatched call.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.assignment import row_min_argmin_plain

#: videos of one batched call: the kernel's grid takes them as its y
#: dimension, at most 65,535 blocks
MAX_VIDEOS = 65535


def row_min_argmin(obj_xy, obj_valid, det_xy, det_valid):
    """Per-row minimum distance and its first minimal column (contract of
    ``assignment.row_min_argmin_plain``), for one problem or for a batch
    of V problems along a leading video axis (the multi-video tracker's;
    one launch whatever V).

    :param obj_xy: (R, K) or (V, R, K) float32, K in (2, 3); obj_valid
        (R,) or (V, R) bool
    :param det_xy: (C, K) or (V, C, K) float32; det_valid (C,) or (V, C)
        bool
    :return: (row_min (R,) or (V, R) float32, cand_col (R,) or (V, R)
        int32)
    """
    if obj_xy.device.type == 'cpu':
        return row_min_argmin_plain(obj_xy, obj_valid, det_xy, det_valid)
    if obj_xy.device.type != 'cuda':
        raise ValueError('row_min_argmin: unsupported device {}'.format(
            obj_xy.device))
    if obj_xy.dim() not in (2, 3) or obj_xy.shape[-1] not in (2, 3):
        raise ValueError('row_min_argmin: obj_xy must be (R, K) or (V, R, '
                         'K), K in 2, 3')
    lead = tuple(obj_xy.shape[:-2])
    v = lead[0] if lead else 1
    if v > MAX_VIDEOS:
        raise ValueError('row_min_argmin: {} videos, the grid takes at most '
                         '{}'.format(v, MAX_VIDEOS))
    r, k = obj_xy.shape[-2:]
    c = det_xy.shape[-2] if det_xy.dim() >= 2 else -1
    for name, a, shape, dtype in (
            ('obj_xy', obj_xy, lead + (r, k), torch.float32),
            ('obj_valid', obj_valid, lead + (r,), torch.bool),
            ('det_xy', det_xy, lead + (c, k), torch.float32),
            ('det_valid', det_valid, lead + (c,), torch.bool)):
        if tuple(a.shape) != shape or a.dtype != dtype or \
                a.device != obj_xy.device or not a.is_contiguous():
            raise ValueError('row_min_argmin: {} must be a contiguous {} {} '
                             'tensor on {}'.format(name, shape, dtype,
                                                   obj_xy.device))
    # both outputs in one allocation: (row_min bits, cand)
    out = torch.empty((2,) + lead + (r,), dtype=torch.int32,
                      device=obj_xy.device)
    row_min, cand = out[0].view(torch.float32), out[1]
    lib = _build.load_kernels()
    # the raw handle of the current stream: torch.cuda.current_stream
    # builds a Stream object on every call, once per tracker frame step
    stream = torch._C._cuda_getCurrentRawStream(obj_xy.device.index)
    rc = lib.ysmr_row_min_argmin(
        obj_xy.data_ptr(), obj_valid.data_ptr(), det_xy.data_ptr(),
        det_valid.data_ptr(), row_min.data_ptr(), cand.data_ptr(), v, r, c,
        k, obj_xy.device.index, stream)
    _build.check(lib, rc, 'assign kernel launch')
    row_min_argmin.launches += 1
    return row_min, cand


#: kernel launches since the count was last set to 0
row_min_argmin.launches = 0
