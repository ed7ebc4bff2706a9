"""Wrapper of the hand-written CUDA kernel for the rotated-extent sweep.

Counterpart of ``ysmr_tpu/ops/pallas_sweep.py::sweep_extents``. The kernel
(``csrc/sweep.cu``) runs one block per component; its source notes the
design and what bounds it. The plain PyTorch version is
``ops/labeling.py::sweep_extents_plain``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.labeling import sweep_extents_plain


def sweep_extents(pts, valid, dx, dy):
    """Extents of the candidate points along per-component directions
    (contract of ``labeling.sweep_extents_plain``).

    :param pts: (D, P, 2) float32; valid (D, P) bool; dx, dy (D, K)
        float32; all contiguous
    :return: (min_u, max_u, min_v, max_v), each (D, K) float32
    """
    if pts.device.type == 'cpu':
        return sweep_extents_plain(pts, valid, dx, dy)
    if pts.device.type != 'cuda':
        raise ValueError('sweep_extents: unsupported device {}'.format(
            pts.device))
    if pts.dim() != 3 or pts.shape[2] != 2 or pts.dtype != torch.float32 \
            or not pts.is_contiguous():
        raise ValueError('sweep_extents: pts must be a contiguous (D, P, 2) '
                         'float32 tensor')
    d, p = pts.shape[:2]
    if valid.shape != (d, p) or valid.dtype != torch.bool or \
            valid.device != pts.device or not valid.is_contiguous():
        raise ValueError('sweep_extents: valid must be a contiguous (D, P) '
                         'bool tensor on the device of pts')
    if dx.dim() != 2 or dx.shape[0] != d:
        raise ValueError('sweep_extents: dx must be (D, K)')
    for name, a in (('dx', dx), ('dy', dy)):
        if a.shape != dx.shape or a.dtype != torch.float32 or \
                a.device != pts.device or not a.is_contiguous():
            raise ValueError('sweep_extents: {} must be a contiguous (D, K) '
                             'float32 tensor on the device of pts'.format(
                                 name))
    k = dx.shape[1]
    outs = [torch.empty((d, k), dtype=torch.float32, device=pts.device)
            for _ in range(4)]
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    rc = lib.ysmr_sweep_extents(
        pts.data_ptr(), valid.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        *(o.data_ptr() for o in outs), d, p, k, pts.device.index, stream)
    _build.check(lib, rc, 'sweep kernel launch')
    sweep_extents.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
sweep_extents.launches = 0
