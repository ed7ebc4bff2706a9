"""Wrapper of the hand-written CUDA kernel for the hull-edge candidates.

Counterpart of ``ysmr_tpu/ops/pallas_hull.py::hull_edge_vectors``, with
the stats tail's ``abs_y`` and ``count`` (``ysmr_tpu/ops/labeling.py::
_stats_tail_from_tables``) folded in: the kernel (``csrc/hull.cu``) takes
``min_y`` and writes ``count``. It runs one warp per component over its
valid rows; its source notes the design and what bounds it. The plain
PyTorch version is ``ops/labeling.py::hull_tables_plain``, which forms
``abs_y`` for ``hull_edge_vectors_plain`` (the Pallas kernel's contract).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.labeling import hull_tables_plain


#: most rows of a component that the kernel keeps in shared memory, 16
#: bytes each, within a block's 232,448 bytes; above, it keeps them in a
#: (D, R) scratch in global memory
HULL_MAX_SHARED_ROWS = 14528


def hull_edge_vectors(row_min_x, row_max_x, row_valid, min_y):
    """Outgoing hull-edge vectors and chain flags per row-extreme point,
    and each component's row-span count (contract of
    ``labeling.hull_tables_plain``).

    :param row_min_x, row_max_x: (D, R) int32, contiguous
    :param row_valid: (D, R) bool
    :param min_y: (D,) int32, the y of each component's row 0
    :return: (dx_l, dy_l, edge_l, dx_r, dy_r, edge_r, corner_l, corner_r),
        (D, R) float32 vectors and bool flags, then count (D,) int32
    """
    if row_min_x.device.type == 'cpu':
        return hull_tables_plain(row_min_x, row_max_x, row_valid, min_y)
    if row_min_x.device.type != 'cuda':
        raise ValueError('hull_edge_vectors: unsupported device {}'.format(
            row_min_x.device))
    if row_min_x.dim() != 2:
        raise ValueError('hull_edge_vectors: tables must be (D, R)')
    for name, a, dtype in (('row_min_x', row_min_x, torch.int32),
                           ('row_max_x', row_max_x, torch.int32),
                           ('row_valid', row_valid, torch.bool)):
        if a.shape != row_min_x.shape or a.dtype != dtype or \
                a.device != row_min_x.device or not a.is_contiguous():
            raise ValueError('hull_edge_vectors: {} must be a contiguous '
                             '(D, R) {} tensor on {}'.format(
                                 name, dtype, row_min_x.device))
    d, r = row_min_x.shape
    if min_y.shape != (d,) or min_y.dtype != torch.int32 or \
            min_y.device != row_min_x.device or not min_y.is_contiguous():
        raise ValueError('hull_edge_vectors: min_y must be a contiguous (D,) '
                         'int32 tensor on {}'.format(row_min_x.device))
    if d * r >= 1 << 31:
        raise ValueError('hull_edge_vectors: D * R too large')
    vec = [torch.empty((d, r), dtype=torch.float32, device=row_min_x.device)
           for _ in range(4)]
    flags = [torch.empty((d, r), dtype=torch.bool, device=row_min_x.device)
             for _ in range(4)]
    count = torch.empty(d, dtype=torch.int32, device=row_min_x.device)
    # the compacted rows, above the shared-memory cap
    scratch = torch.empty((d, r, 4) if r > HULL_MAX_SHARED_ROWS else 0,
                          dtype=torch.float32, device=row_min_x.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(row_min_x.device).cuda_stream
    rc = lib.ysmr_hull_edges(
        row_min_x.data_ptr(), row_max_x.data_ptr(), row_valid.data_ptr(),
        min_y.data_ptr(), vec[0].data_ptr(), vec[1].data_ptr(),
        flags[0].data_ptr(), vec[2].data_ptr(), vec[3].data_ptr(),
        flags[1].data_ptr(), flags[2].data_ptr(), flags[3].data_ptr(),
        count.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
        d, r, row_min_x.device.index, stream)
    _build.check(lib, rc, 'hull kernel launch')
    hull_edge_vectors.launches += 1
    return (vec[0], vec[1], flags[0], vec[2], vec[3], flags[1], flags[2],
            flags[3], count)


#: kernel launches since the count was last set to 0
hull_edge_vectors.launches = 0
