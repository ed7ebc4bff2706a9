"""Wrapper of the hand-written CUDA kernel for the rotated-extent sweep.

Counterpart of ``ysmr_tpu/ops/pallas_sweep.py::sweep_extents`` and of the
candidate points it reads (``ysmr_tpu/ops/labeling.py::
_stats_tail_from_tables``): the kernel (``csrc/sweep.cu``) reads the row
tables at the hull's strict chain corners and takes the horizontal
direction (1, 0) as implicit. It runs one warp per component; its source
notes the design and what bounds it. The plain PyTorch version is
``ops/labeling.py::sweep_tables_plain``, ``sweep_extents_plain`` (the
Pallas kernel's contract) over the corners.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.labeling import sweep_tables_plain


def sweep_extents(row_min_x, row_max_x, row_valid, min_y, corner_l,
                  corner_r, edge_dx, edge_dy):
    """Extents of each component's strict corners along its edge
    candidates and (1, 0) (contract of ``labeling.sweep_tables_plain``).

    :param row_min_x, row_max_x: (D, R) int32; row_valid, corner_l,
        corner_r (D, R) bool; min_y (D,) int32; all contiguous
    :param edge_dx, edge_dy: (D, K - 1) float32, contiguous
    :return: (min_u, max_u, min_v, max_v), each (D, K) float32
    """
    dev = row_min_x.device
    if dev.type == 'cpu':
        return sweep_tables_plain(row_min_x, row_max_x, row_valid, min_y,
                                  corner_l, corner_r, edge_dx, edge_dy)
    if dev.type != 'cuda':
        raise ValueError('sweep_extents: unsupported device {}'.format(dev))
    if row_min_x.dim() != 2 or edge_dx.dim() != 2:
        raise ValueError('sweep_extents: tables (D, R) and candidates '
                         '(D, K - 1)')
    d, r = row_min_x.shape
    k = edge_dx.shape[1] + 1
    for name, a, shape, dtype in (
            ('row_min_x', row_min_x, (d, r), torch.int32),
            ('row_max_x', row_max_x, (d, r), torch.int32),
            ('row_valid', row_valid, (d, r), torch.bool),
            ('min_y', min_y, (d,), torch.int32),
            ('corner_l', corner_l, (d, r), torch.bool),
            ('corner_r', corner_r, (d, r), torch.bool),
            ('edge_dx', edge_dx, (d, k - 1), torch.float32),
            ('edge_dy', edge_dy, (d, k - 1), torch.float32)):
        if tuple(a.shape) != shape or a.dtype != dtype or \
                a.device != dev or not a.is_contiguous():
            raise ValueError('sweep_extents: {} must be a contiguous {} {} '
                             'tensor on {}'.format(name, shape, dtype, dev))
    if d * max(r, k) >= 1 << 31:
        raise ValueError('sweep_extents: D * R or D * K too large')
    outs = [torch.empty((d, k), dtype=torch.float32, device=dev)
            for _ in range(4)]
    lib = _build.load_kernels()
    rc = lib.ysmr_sweep_extents(
        row_min_x.data_ptr(), row_max_x.data_ptr(), row_valid.data_ptr(),
        min_y.data_ptr(), corner_l.data_ptr(), corner_r.data_ptr(),
        edge_dx.data_ptr(), edge_dy.data_ptr(),
        *(o.data_ptr() for o in outs), d, r, k, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'sweep kernel launch')
    sweep_extents.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
sweep_extents.launches = 0
