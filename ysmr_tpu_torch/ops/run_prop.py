"""Wrapper of the hand-written CUDA kernel for the run-graph CC fixpoint.

Counterpart of ``ysmr_tpu/ops/pallas_run_prop.py::propagate_min_fused``. The
kernel (``csrc/run_prop.cu``) runs the whole fixpoint of every frame in one
launch, one thread block per frame; its source notes the design and what
bounds it. The plain PyTorch version is ``ops/run_cc.py::propagate_min``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.run_cc import propagate_min


def _kernel_inputs(init, win, link):
    """Endpoint planes (T, 4, R) int32 with invalid endpoints pointing at
    the run itself (a self-min is the identity), and the links as uint8."""
    t, r = init.shape
    iota = torch.arange(r, dtype=torch.int32, device=init.device).expand(t, r)
    planes = [torch.where(win[ok], win[k].clamp(0, r - 1), iota)
              for k, ok in (('lo_up', 'ok_up'), ('hi_up', 'ok_up'),
                            ('lo_dn', 'ok_dn'), ('hi_dn', 'ok_dn'))]
    idx4 = torch.stack(planes, dim=1).to(torch.int32).contiguous()
    return idx4, link.to(torch.uint8).contiguous()


def propagate_min_fused(init, win, link, *, max_iters=64):
    """Min-label fixpoint over the run graph (contract of
    ``run_cc.propagate_min``).

    :param init: (T, R) int32 initial labels, contiguous, all < 2R
    :param win: run_windows output ((T, R) int32 / bool planes)
    :param link: (T, R) bool chain_mask output
    :return: ((T, R) int32 labels, (T,) int32 sweeps that changed a label —
        the frame converged iff steps < max_iters)
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
    for key in ('lo_up', 'hi_up', 'lo_dn', 'hi_dn', 'ok_up', 'ok_dn'):
        if win[key].shape != init.shape or win[key].device != init.device:
            raise ValueError('propagate_min_fused: window plane {} does '
                             'not match init'.format(key))
    if link.shape != init.shape or link.dtype != torch.bool or \
            link.device != init.device:
        raise ValueError('propagate_min_fused: link must be (T, R) bool on '
                         'the device of init')
    if max_iters < 0 or r >= 1 << 30:
        raise ValueError('propagate_min_fused: bad max_iters or R')
    idx4, link_u8 = _kernel_inputs(init, win, link)
    out = torch.empty_like(init)
    steps = torch.empty(t, dtype=torch.int32, device=init.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(init.device).cuda_stream
    rc = lib.ysmr_run_prop(init.data_ptr(), idx4.data_ptr(),
                           link_u8.data_ptr(), out.data_ptr(),
                           steps.data_ptr(), t, r, int(max_iters),
                           init.device.index, stream)
    _build.check(lib, rc, 'run_prop kernel launch')
    propagate_min_fused.launches += 1
    return out, steps


#: kernel launches since the count was last set to 0
propagate_min_fused.launches = 0
