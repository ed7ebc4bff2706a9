"""The tracker frame step's match-and-register block.

Counterpart of the plain-XLA body of ``ysmr_tpu/pipeline/tracker.py``'s
``_tracker_frame_update`` outside the assignment's distances and the GSFF
step: the greedy first-come match (``ysmr_tpu/ops/assignment.py:67``
``greedy_assign_from_candidates``), ageing and deregistration,
registration in ascending column order, and the frame's emissions. XLA
fuses it inside the jitted scan; eagerly it is some 120 small torch ops a
frame step.

``match_and_register`` takes the per-slot candidates in slot order
(``ops/assign.py::row_min_argmin`` on ``state['pos']`` and
``state['active']`` as they are: a row's minimum and first minimal column
do not depend on the order of the rows). On a CUDA tensor it is the
hand-written kernel ``csrc/frame_step.cu`` (two launches, counted as one
call); on a CPU tensor ``match_and_register_plain``, the torch sequence:
the slot argsort by id, ``greedy_assign_from_candidates`` on the gathered
candidates, the scatter back to slots, ageing, registration and the
emissions. With GSFF, the filter step that follows it
(``ops/gsff.py::_register_and_step``) writes its corrected and predicted
positions over the first two coordinates of the live slots' emitted and
new positions itself. Nothing falls back from the kernel to its plain
version.

The block does no float arithmetic besides one comparison (the aged
count, rounded to float32, against ``max_disappeared``), so the kernel is
bit-equal to the plain version by construction.
"""

import ctypes

import numpy as np
import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import assignment as asg
from ysmr_tpu_torch.ops import gsff as gsff_ops

INT_MAX = 2 ** 31 - 1

#: the keys of a tracker state this block reads and writes, in the
#: kernel's argument order
STATE_KEYS = ('active', 'ids', 'pos', 'info', 'disappeared', 'next_id',
              'dropped_registrations')
#: the keys of a frame's emission, in the kernel's argument order
EMISSION_KEYS = ('mask', 'ids', 'pos', 'info', 'det_col', 'n_det')
#: the per-slot masks the GSFF block reads (``flags[i]`` of ``allocate``)
FLAGS = ('matched', 'reg_slot', 'coasting')

_F32, _I32, _B8 = torch.float32, torch.int32, torch.bool


def _gather_rows(table, idx):
    """``table[v, idx[v, s]]`` for a (V, N, D) table and (V, S) indices:
    (V, S, D)."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1,
                                                         table.shape[2]))


def match_and_register_plain(state, row_min, cand, det_xy, det_info,
                             det_valid, *, max_disappeared):
    """Plain version of ``csrc/frame_step.cu``: the rows in ascending-id
    order (active slots by id, ties by slot, then the free slots),
    the slot-order candidates gathered into them,
    ``greedy_assign_from_candidates``, the result scattered back to
    slots, ageing and deregistration, registration and the emissions.

    :return: (new_state, emission, matched, reg_slot, coasting): the
        state's seven tensors, the frame's emission (``mask``, ``ids``,
        ``det_col`` (V, S), ``pos`` (V, S, K), ``info`` (V, S, 3), ``n_det``
        (V,)), and three (V, S) bool masks
    """
    active = state['active']
    ids = state['ids']
    pos = state['pos']
    info = state['info']
    disappeared = state['disappeared']
    next_id = state['next_id']
    v, s = active.shape
    c = det_valid.shape[1]
    i32 = _I32

    perm = torch.argsort(torch.where(active, ids, torch.full_like(
        ids, INT_MAX)), dim=1, stable=True)
    res = asg.greedy_assign_from_candidates(
        torch.gather(row_min, 1, perm), torch.gather(cand, 1, perm),
        torch.gather(active, 1, perm), det_valid)
    n_obj = active.sum(dim=1, dtype=i32)
    n_det = det_valid.sum(dim=1, dtype=i32)
    has_det = n_det > 0

    slot_to_col = torch.full((v, s), -1, dtype=torch.long,
                             device=active.device)
    slot_to_col.scatter_(1, perm, res['row_to_col'])
    col_matched = res['col_matched']

    matched = has_det[:, None] & (slot_to_col >= 0)
    col_idx = torch.clamp(slot_to_col, 0, c - 1)
    pos_new = torch.where(matched[..., None], _gather_rows(det_xy, col_idx),
                          pos)
    info_new = torch.where(matched[..., None],
                           _gather_rows(det_info, col_idx), info)
    zero_i = torch.zeros_like(disappeared)
    dis_new = torch.where(matched, zero_i, disappeared)

    # ageing: all active slots when the frame is empty; unmatched active
    # slots when rows >= cols
    age_mask = torch.where(has_det[:, None],
                           active & ~matched & (n_obj >= n_det)[:, None],
                           active)
    dis_new = dis_new + age_mask.to(i32)
    info_new = torch.where(age_mask[..., None], torch.zeros_like(info_new),
                           info_new)
    dereg = age_mask & (dis_new.to(torch.float32) > max_disappeared)
    active_new = active & ~dereg

    # registration: unmatched detections when cols > rows, in ascending
    # column order (the host renumbers into the reference's set order)
    do_register = has_det & (n_det > n_obj)
    unmatched_col = det_valid & ~col_matched & do_register[:, None]
    col_rank = torch.cumsum(unmatched_col.to(i32), 1, dtype=i32) - 1
    n_new = unmatched_col.sum(dim=1, dtype=i32)
    free = ~active_new
    free_rank = torch.cumsum(free.to(i32), 1, dtype=i32) - 1
    # col_of_rank[v, k] = the column holding video v's k-th registration
    # (column c is the dump of the JAX scatter's mode='drop')
    col_of_rank = torch.zeros((v, c + 1), dtype=i32, device=active.device)
    col_of_rank.scatter_(1, torch.where(unmatched_col, col_rank,
                                        torch.full_like(col_rank, c)).long(),
                         torch.arange(c, dtype=i32,
                                      device=active.device).expand(v, c))
    reg_slot = free & (free_rank < n_new[:, None])
    reg_col = torch.gather(col_of_rank, 1,
                           torch.clamp(free_rank, 0, c - 1).long())
    n_registered = reg_slot.sum(dim=1, dtype=i32)
    dropped = state['dropped_registrations'] + (n_new - n_registered)

    active_new = active_new | reg_slot
    ids_new = torch.where(reg_slot, next_id[:, None] + free_rank, ids)
    reg_col_l = reg_col.long()
    pos_new = torch.where(reg_slot[..., None], _gather_rows(det_xy, reg_col_l),
                          pos_new)
    info_new = torch.where(reg_slot[..., None],
                           _gather_rows(det_info, reg_col_l), info_new)
    dis_new = torch.where(reg_slot, zero_i, dis_new)
    next_id_new = next_id + n_new

    new_state = {
        'active': active_new,
        'ids': ids_new,
        'pos': pos_new,
        'info': info_new,
        'disappeared': dis_new,
        'next_id': next_id_new,
        'dropped_registrations': dropped,
    }
    neg1 = torch.full_like(slot_to_col, -1)
    emission = {
        'mask': active_new,
        'ids': torch.where(active_new, ids_new, torch.zeros_like(ids_new)),
        'pos': pos_new,
        'info': info_new,
        # the detection column each live slot consumed this frame (-1 while
        # coasting) and the frame's detection count, for the renumberer
        'det_col': torch.where(matched, slot_to_col,
                               torch.where(reg_slot, reg_col_l,
                                           neg1)).to(i32),
        'n_det': n_det,
    }
    # a coasting slot (active, unmatched, not newly registered) feeds its
    # own prediction back to the GSFF step
    coasting = active_new & ~matched & ~reg_slot
    return new_state, emission, matched, reg_slot, coasting


def allocate(state, c, frames=1):
    """Output buffers of ``frames`` frame steps of ``match_and_register``
    for the (V, S) slot tables of ``state`` and C detections a frame:
    ``states``, two new states (one for a single frame) that the frames
    alternate between; ``emission``, the (V, frames, S, ...) emissions
    (``n_det`` (V, frames)); ``flags``, the (3, V, S) bool masks of
    ``FLAGS``; ``scratch``, the kernel's (V, S + 2 C) int32 ranks, column
    winners and registration columns; and where ``state`` holds a
    flattened GSFF state (key ``gsff``), ``gsff``, the GSFF block's
    buffers (``ops/gsff.py::allocate``)."""
    active = state['active']
    v, s = active.shape
    k = state['pos'].shape[2]
    dev = active.device

    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def new_state():
        return {'active': empty(v, s, dtype=_B8), 'ids': empty(v, s, dtype=_I32),
                'pos': empty(v, s, k), 'info': empty(v, s, 3),
                'disappeared': empty(v, s, dtype=_I32),
                'next_id': empty(v, dtype=_I32),
                'dropped_registrations': empty(v, dtype=_I32)}

    out = {
        'states': tuple(new_state() for _ in range(min(frames, 2))),
        'emission': {'mask': empty(v, frames, s, dtype=_B8),
                     'ids': empty(v, frames, s, dtype=_I32),
                     'pos': empty(v, frames, s, k),
                     'info': empty(v, frames, s, 3),
                     'det_col': empty(v, frames, s, dtype=_I32),
                     'n_det': empty(v, frames, dtype=_I32)},
        'flags': empty(len(FLAGS), v, s, dtype=_B8),
        'scratch': empty(v, s + 2 * c, dtype=_I32),
    }
    if 'gsff' in state:
        out['gsff'] = gsff_ops.allocate(state['gsff'], frames)
    return out


def _frame_outputs(out, frame):
    """The views frame ``frame`` writes: (new state, emission, flags)."""
    states = out['states']
    return (states[frame % len(states)],
            {key: x[:, frame] for key, x in out['emission'].items()},
            out['flags'])


def write_plain(out, frame, result):
    """Copy a plain result (``match_and_register_plain``'s tuple) into the
    outputs of frame ``frame``; returns them as ``match_and_register``
    does."""
    new_state, emission, flags = _frame_outputs(out, frame)
    got_state, got_emission = result[:2]
    for key in STATE_KEYS:
        new_state[key].copy_(got_state[key])
    for key in EMISSION_KEYS:
        emission[key].copy_(got_emission[key])
    for i, mask in enumerate(result[2:]):
        flags[i].copy_(mask)
    return (new_state, emission) + tuple(flags)


def check(state, det_xy, det_info, det_valid, row_min=None, cand=None):
    """Raise unless the tensors are what ``match_and_register`` takes: a
    (V, S) slot table (``active`` bool, ``ids`` and ``disappeared``
    int32, ``pos`` (V, S, K) and ``info`` (V, S, 3) float32, ``next_id``
    and ``dropped_registrations`` (V,) int32), the frame's (V, C, K)
    ``det_xy`` and (V, C, 3) ``det_info`` float32 and (V, C) ``det_valid``
    bool, and (V, S) float32 ``row_min`` and int32 ``cand``; all on one
    device, the CPU or CUDA, and contiguous on CUDA."""
    active = state['active']
    dev = active.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError('match_and_register: unsupported device {}'.format(
            dev))
    if active.dim() != 2 or state['pos'].dim() != 3 or det_valid.dim() != 2:
        raise ValueError('match_and_register: the slot table and the '
                         'detections need a leading video axis')
    v, s = active.shape
    k = state['pos'].shape[2]
    c = det_valid.shape[1]
    want = [('active', active, (v, s), _B8),
            ('ids', state['ids'], (v, s), _I32),
            ('pos', state['pos'], (v, s, k), _F32),
            ('info', state['info'], (v, s, 3), _F32),
            ('disappeared', state['disappeared'], (v, s), _I32),
            ('next_id', state['next_id'], (v,), _I32),
            ('dropped_registrations', state['dropped_registrations'], (v,),
             _I32),
            ('det_xy', det_xy, (v, c, k), _F32),
            ('det_info', det_info, (v, c, 3), _F32),
            ('det_valid', det_valid, (v, c), _B8)]
    if row_min is not None:
        want += [('row_min', row_min, (v, s), _F32),
                 ('cand', cand, (v, s), _I32)]
    for name, a, shape, dtype in want:
        if not torch.is_tensor(a) or tuple(a.shape) != shape or \
                a.dtype != dtype or a.device != dev or \
                (dev.type == 'cuda' and not a.is_contiguous()):
            raise ValueError('match_and_register: {} must be a {} {} tensor '
                             'on {}{}'.format(name, shape, dtype, dev,
                                              ', contiguous' if dev.type ==
                                              'cuda' else ''))
    if c < 1:
        raise ValueError('match_and_register: a frame needs at least one '
                         'detection column')


def _match_and_register(state, row_min, cand, det_xy, det_info, det_valid, *,
                        max_disappeared, out, frame):
    """``match_and_register`` on checked tensors into ``allocate``'s
    buffers ``out``, frame ``frame``: the private entry of the tracker's
    scan, which checks its tables once."""
    if det_valid.device.type == 'cpu':
        return write_plain(out, frame, match_and_register_plain(
            state, row_min, cand, det_xy, det_info, det_valid,
            max_disappeared=max_disappeared))
    new_state, emission, flags = _frame_outputs(out, frame)
    v, s = state['active'].shape
    c = det_valid.shape[1]
    k = state['pos'].shape[2]
    dev = det_valid.device
    lib = _build.load_kernels()
    rc = lib.ysmr_frame_step(
        *(state[key].data_ptr() for key in STATE_KEYS),
        row_min.data_ptr(), cand.data_ptr(), det_xy.data_ptr(),
        det_info.data_ptr(), det_valid.data_ptr(),
        *(new_state[key].data_ptr() for key in STATE_KEYS),
        *(emission[key].data_ptr() for key in EMISSION_KEYS),
        flags.data_ptr(), out['scratch'].data_ptr(),
        # max_disappeared as torch compares it with a float32 tensor
        ctypes.c_float(np.float32(max_disappeared)), v, s, c, k,
        out['emission']['mask'].shape[1], dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, rc, 'frame step kernel launch')
    match_and_register.launches += 1
    return (new_state, emission) + tuple(flags)


def match_and_register(state, row_min, cand, det_xy, det_info, det_valid, *,
                       max_disappeared):
    """One frame of the tracker's greedy match, ageing, deregistration,
    registration and emissions over V videos' slot tables (contract of
    ``match_and_register_plain``): on a CPU tensor the plain version, on a
    CUDA tensor ``csrc/frame_step.cu`` (bit-equal), or the call raises.
    The inputs are never written. The tracker's scan, which checks its
    tables once and writes a batch of frames into one allocation, calls
    ``_match_and_register`` instead.

    :param state: the slot table (``check``); other keys are ignored
    :param row_min, cand: (V, S) the slot-order candidates
        (``row_min_argmin`` on ``state['pos']`` and ``state['active']``)
    :param det_xy, det_info, det_valid: the frame's (V, C, ...) detections
    :param max_disappeared: the grace of an unmatched track, in frames
    :return: (new_state, emission, matched, reg_slot, coasting) as the
        plain version's, in new tensors
    """
    check(state, det_xy, det_info, det_valid, row_min, cand)
    return _match_and_register(state, row_min, cand, det_xy, det_info,
                               det_valid, max_disappeared=max_disappeared,
                               out=allocate(state, det_valid.shape[1]),
                               frame=0)


#: kernel calls since the count was last set to 0
match_and_register.launches = 0
