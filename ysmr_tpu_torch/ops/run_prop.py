"""Wrapper of the hand-written CUDA kernel for the run-graph CC fixpoint.

Counterpart of ``ysmr_tpu/ops/pallas_run_prop.py::propagate_min_fused``. The
kernel (``csrc/run_prop.cu``) is a union-find over every run's edges with
the minimum label carried at the roots; its source notes the design and
what bounds it. It reads the window planes, the two
``ok`` planes and the links as the pipeline holds them, so the wrapper
launches nothing but the kernel. The plain PyTorch version is
``ops/run_cc.py::propagate_min``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import ctypes

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.run_cc import propagate_min

def propagate_min_fused(init, win, link, *, max_iters=64):
    """Min-label fixpoint over the run graph (contract of
    ``run_cc.propagate_min`` at its fixpoint).

    The kernel has no sweeps: it always reaches the fixpoint and returns 0
    steps for every frame (so "converged iff steps < max_iters" holds for
    every ``max_iters >= 1``); ``max_iters = 0`` returns a copy of ``init``,
    as the plain version does.

    :param init: (T, R) int32 initial labels, contiguous, 0 <= init < 2R,
        each naming (mod R) a run of its own component
    :param win: run_windows output ((T, R) int32 / bool planes)
    :param link: (T, R) bool chain_mask output
    :return: ((T, R) int32 labels, (T,) int32 steps — on the CPU the sweeps
        that changed a label, on the card 0)
    """
    if init.device.type == 'cpu':
        return propagate_min(init, win, link, max_iters=max_iters)
    if init.device.type != 'cuda':
        raise ValueError('propagate_min_fused: unsupported device {}'.format(
            init.device))
    if init.dtype != torch.int32 or init.dim() != 2 or \
            not init.is_contiguous():
        raise ValueError('propagate_min_fused: init must be a contiguous '
                         '(T, R) int32 tensor')
    t, r = init.shape
    planes = []
    for key, dtype in (('lo_up', torch.int32), ('hi_up', torch.int32),
                       ('lo_dn', torch.int32), ('hi_dn', torch.int32),
                       ('ok_up', torch.bool), ('ok_dn', torch.bool)):
        a = win[key]
        if a.shape != init.shape or a.device != init.device or \
                a.dtype != dtype:
            raise ValueError('propagate_min_fused: window plane {} does '
                             'not match init'.format(key))
        # the pipeline's endpoint planes are contiguous or slices along R
        # of one searchsorted result: the kernel takes their row stride
        if a.stride(1) != 1 or (dtype == torch.bool and
                                not a.is_contiguous()):
            a = a.contiguous()
        planes.append(a)
    if link.shape != init.shape or link.dtype != torch.bool or \
            link.device != init.device:
        raise ValueError('propagate_min_fused: link must be (T, R) bool on '
                         'the device of init')
    if max_iters < 0 or r >= 1 << 30:
        raise ValueError('propagate_min_fused: bad max_iters or R')
    out = torch.empty_like(init)
    steps = torch.empty(t, dtype=torch.int32, device=init.device)
    scratch = torch.empty_like(init)
    link = link if link.is_contiguous() else link.contiguous()
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(init.device).cuda_stream
    strides = (ctypes.c_int64 * 4)(*(a.stride(0) for a in planes[:4]))
    rc = lib.ysmr_run_prop(init.data_ptr(), *(a.data_ptr() for a in planes),
                           link.data_ptr(), strides, scratch.data_ptr(),
                           out.data_ptr(), steps.data_ptr(), t, r,
                           int(max_iters), init.device.index, stream)
    _build.check(lib, rc, 'run_prop kernel launch')
    propagate_min_fused.launches += 1
    return out, steps


#: kernel launches since the count was last set to 0
propagate_min_fused.launches = 0
