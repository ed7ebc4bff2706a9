"""Device-resident centroid tracker over padded slot tables (PyTorch).

Counterpart of ``ysmr_tpu/pipeline/tracker.py``, whose docstring sets out
how the reference's ``CentroidTracker`` (tracker.py:27-230) maps onto a
slot table: rows in ascending-id order, the greedy first-come match
(``ops/assignment.py``), ageing and deregistration, registration in
ascending column order, and the GSFF correct/predict block.

``lax.scan`` becomes a Python loop over the frames of a batch; the frame
step's shapes are static. The frame step always works over a leading
video axis V: one video is V = 1, and the multi-video step's ``jax.vmap``
over a device's videos becomes one scan over its (V, T, ...) tables, so
a frame step serves all V videos. On a CUDA tensor a frame step is three
kernels, four with GSFF (luminosity's third coordinate too): the per-slot
nearest detection
(``ops/assign.py::row_min_argmin``, ``csrc/assign.cu``), the match,
ageing, registration and emissions
(``ops/frame_step.py::match_and_register``, ``csrc/frame_step.cu``, two
launches), and with GSFF the filter step
(``ops/gsff.py::register_and_step``, ``csrc/gsff.cu``), which also writes
its outputs over the live slots' new and emitted positions; on a CPU
tensor each is its plain torch version. The scan checks its tables once
and calls the blocks' private entries (``frame_step._match_and_register``,
``gsff._register_and_step``), which write into buffers allocated once a
scan. With ``assign_mesh`` the per-slot nearest
detection is computed with the slots sharded over a device mesh
(``parallel/sharding.py::sharded_row_min_argmin``, the assign kernel on
each shard) and the rest of the step is the same.
``ReferenceOrderRenumberer`` is host numpy, copied from the JAX module.

``compact_emissions_device`` (the opt-in ``compact emissions readback``)
is a stable sort and a gather in plain torch ops; the JAX function's
multi-operand ``lax.sort`` becomes one sort of the live/dead key and one
gather of the payload, bit-cast into int32 the same way.
"""

import numpy as np
import torch

from ysmr_tpu_torch.ops import frame_step as fs
from ysmr_tpu_torch.ops import gsff as gsff_ops
from ysmr_tpu_torch.ops.assign import row_min_argmin
from ysmr_tpu_torch.parallel import sharding as shd


# Copied from ysmr_tpu/pipeline/tracker.py (ReferenceOrderRenumberer).
class ReferenceOrderRenumberer:
    """Rewrites device-tracker TRACK_IDs into the reference's numbering.

    The reference registers unmatched detections by iterating
    ``set(range(n_det)).difference(used_cols)`` (reference tracker.py:73-91)
    — the slot order of CPython's small-int hash table, which deviates from
    ascending once indices wrap the table. The device scan registers the
    same detections in ascending column order (a fixed, compiler-friendly
    rule) and additionally emits which detection column each slot consumed
    (``det_col``) plus the per-frame detection count (``n_det``). This
    helper replays every frame's registrations through the real CPython set
    machinery at readback and accumulates an id remap — the renumbered ids
    are exact by construction, with zero device-side cost beyond the two
    extra emission columns. Batches must be observed in frame order.

    Scope: the remap makes REGISTRATION order exact. After a permuted
    registration block, the device's distance-matrix row order (ascending
    device id) no longer equals the reference's OrderedDict insertion
    order (ascending renumbered id), so greedy matching can still diverge
    from the reference on EXACT distance ties in later frames — the same
    class of residual as the documented near-tie greedy flips. Id-level
    exactness therefore does not imply match-level exactness; the float64
    host tracker (native/tracker64.cpp) remains the bit-exact path.
    """

    def __init__(self):
        self._remap = np.arange(0, dtype=np.int64)
        self._seen_max = -1

    def _grow(self, n):
        if n > self._remap.shape[0]:
            old = self._remap
            self._remap = np.arange(max(n, 2 * old.shape[0]), dtype=np.int64)
            self._remap[:old.shape[0]] = old

    def observe_batch(self, mask, ids, det_col, n_det, frame_valid):
        """Fold one batch's padded emissions into the remap; returns the
        remapped ids (same shape as ``ids``, entries under ``mask`` valid).
        """
        mask = np.asarray(mask)
        ids = np.asarray(ids)
        det_col = np.asarray(det_col)
        n_det = np.asarray(n_det)
        live_ids = np.where(mask, ids, -1)
        self._grow(int(live_ids.max(initial=-1)) + 1)
        frame_max = live_ids.max(axis=1, initial=-1)
        # only frames that registered something need the set replay
        for t in np.nonzero(frame_valid & (frame_max > self._seen_max))[0]:
            row_live = mask[t]
            row_ids = ids[t][row_live]
            row_cols = det_col[t][row_live]
            # _seen_max moves inside this loop; the nonzero() pre-filter
            # used its entry value, so re-check per frame
            fresh = row_ids > self._seen_max
            if not fresh.any():
                continue
            used_cols = set(
                int(c) for c in row_cols[~fresh] if c >= 0)
            # the real CPython iteration order the reference registers in
            order = list(set(range(int(n_det[t]))).difference(used_cols))
            rank = {d: i for i, d in enumerate(order)}
            new_ids = np.sort(row_ids[fresh])
            # ascending device ids correspond to ascending detection columns
            new_cols = np.sort(row_cols[fresh])
            base = int(new_ids[0])
            for j, d in enumerate(new_cols):
                # rank defaults to j if a column is unexpectedly absent
                # (capacity drops break reference parity anyway)
                self._remap[new_ids[j]] = base + rank.get(int(d), j)
            self._seen_max = int(frame_max[t]) \
                if frame_max[t] > self._seen_max else self._seen_max
        out = self._remap[np.clip(ids, 0, self._remap.shape[0] - 1)]
        return np.where(mask, out, ids).astype(ids.dtype)


def init_tracker_state(max_slots, device, dims=2, use_gsff=False,
                       gsff_params=None):
    """Fresh tracker state (a dict of tensors on ``device``). ``dims`` is 2
    or 3 (with luminosity)."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {
        'active': zeros(max_slots, dtype=torch.bool),
        'ids': zeros(max_slots, dtype=torch.int32),
        'pos': zeros(max_slots, dims),
        'info': zeros(max_slots, 3),
        'disappeared': zeros(max_slots, dtype=torch.int32),
        'next_id': zeros(dtype=torch.int32),
        'dropped_registrations': zeros(dtype=torch.int32),
    }
    if use_gsff:
        state['gsff'] = gsff_ops.init_state(gsff_params, max_slots, device)
    return state


def gsff_kwargs(params, device):
    """The GSFF keyword arguments of ``run_tracker_scan`` for a bank."""
    return {'gsff_gains': params.gains_on(device),
            'gsff_n_i': torch.tensor(params.n_i, dtype=torch.int32,
                                     device=device),
            'gsff_n_f': params.n_f, 'gsff_n_i0': params.n_i[0]}


def tracker_state_from_numpy(state, device, gsff_params=None):
    """A ``ysmr_tpu`` tracker state (the ``init_tracker_state`` pytree as
    numpy arrays, GSFF sub-state included) as this module's state on
    ``device``, plus the GSFF keyword arguments of ``run_tracker_scan``
    built from ``gsff_params`` (empty without a bank).

    :return: (state, tracker keyword arguments)
    """
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    out = conv(dict(state))
    extra = gsff_kwargs(gsff_params, device) if gsff_params is not None \
        else {}
    return out, extra


def _tracker_frame_update(state, det_xy, det_info, det_valid, *,
                          max_disappeared, use_gsff, gsff_gains, gsff_n_i,
                          gsff_n_f, gsff_n_i0, out, frame, assign_mesh=None):
    """One frame of CentroidTracker.update semantics over the slot table,
    for V videos at once: every tensor of ``state`` and the frame's
    detections carry a leading video axis (``next_id`` and
    ``dropped_registrations`` (V,)), and each video's result is the one a
    step of that video alone gives. The GSFF sub-state is per slot and
    stays flattened to (V * S, ...) through the scan. The step writes
    frame ``frame`` of ``ops/frame_step.py::allocate``'s buffers ``out``
    and trusts its tables: the scan checks them once and allocates once.

    On a CUDA tensor the step is the assign kernel on the slot table as it
    is (on each shard with ``assign_mesh``), the frame-step kernel
    (``frame_step._match_and_register``) and, with GSFF, the GSFF kernel,
    which writes the emitted (corrected) and stored (predicted) positions
    of the live slots itself."""
    active = state['active']
    v = active.shape[0]
    # the candidates in slot order: a row's minimum and first minimal
    # column do not depend on the order of the rows
    if assign_mesh is None:
        row_min, cand = row_min_argmin(state['pos'], active, det_xy,
                                       det_valid)
    elif v != 1:
        raise ValueError('run_tracker_scan: assign_mesh takes one video, '
                         'not {}'.format(v))
    else:
        # dense-scene path: the slots x detections rows sharded over the
        # mesh; only the O(slots) minima come back, across processes too
        row_min, cand = (x[None] for x in shd.sharded_row_min_argmin(
            assign_mesh, state['pos'][0], active[0], det_xy[0],
            det_valid[0]))
    new_state, emission, _, reg_slot, coasting = fs._match_and_register(
        state, row_min, cand, det_xy, det_info, det_valid,
        max_disappeared=max_disappeared, out=out, frame=frame)
    if use_gsff:
        # the filter works per slot: the (V, S) slots flattened to V * S
        # (views of contiguous tensors) through the unbatched filter step,
        # the measurement the first two of the K coordinates (no copy);
        # newly registered slots start with the ring filled with m, and a
        # coasting slot (active, unmatched, not newly registered) feeds its
        # own stored prediction back, with the lo half re-attached; on
        # every live slot the emitted position becomes the corrected one
        # and the stored one the prediction
        gstate = gsff_ops._register_and_step(
            gsff_gains, gsff_n_i, gsff_n_f, gsff_n_i0, state['gsff'],
            new_state['pos'].flatten(0, 1), new_state['active'].flatten(),
            reg_slot.flatten(), coasting.flatten(), out=out['gsff'],
            frame=frame, emit_pos=emission['pos'])[0]
        new_state = dict(new_state, gsff=gstate)
    return new_state, emission


def run_tracker_scan(state, det_xy, det_info, det_valid, *, max_disappeared,
                     use_gsff=False, gsff_gains=None, gsff_n_i=None,
                     gsff_n_f=3, gsff_n_i0=10, assign_mesh=None):
    """Run the tracker over a batch of frames, of one video or of V videos
    at once (the counterpart of ``jax.vmap`` over the JAX scan: one frame
    step, and one assign launch, per frame for all V).

    The tables are checked once per call, and the outputs allocated once:
    the (V, T, S) emissions, which each frame step writes in place, and
    two state buffers, the GSFF sub-state's too, that the frames alternate
    between (after a frame, the returned state never aliases the
    caller's).

    :param state: tracker state (carried between batches); with a leading
        video axis V on every tensor for V videos
    :param det_xy: (T, C, K) float32 detection positions, or (V, T, C, K)
    :param det_info: (T, C, 3) float32 (w, h, angle) per detection, or
        (V, T, C, 3)
    :param det_valid: (T, C) bool, or (V, T, C)
    :param assign_mesh: optional ``parallel.sharding.Mesh``: the frame
        step's assignment rows sharded over it (S divisible by its size);
        one video only
    :return: (new_state, emissions) — emissions are (T, S) padded tensors
        (``n_det`` (T,)), or (V, T, S) and (V, T) for V videos; each
        video's the bits of its own scan
    """
    batched = det_valid.dim() == 3
    if state['active'].dim() != (2 if batched else 1):
        raise ValueError('run_tracker_scan: the state and the detections '
                         'disagree on the video axis')
    if not batched:
        state = shd._tree_map(lambda x: x[None], state)
        det_xy, det_info, det_valid = det_xy[None], det_info[None], \
            det_valid[None]
    v, t_len, c = det_valid.shape
    # frame-major copies, so each frame's (V, C, ...) slice is contiguous
    # (no copy for one video)
    det_xy, det_info, det_valid = (x.transpose(0, 1).contiguous() for x in
                                   (det_xy, det_info, det_valid))
    s = state['active'].shape[1]
    gsff = state.get('gsff')
    state = {k: x.contiguous() for k, x in state.items() if k != 'gsff'}
    if use_gsff:
        state['gsff'] = {k: x.flatten(0, 1).contiguous()
                         for k, x in gsff.items()}
    if t_len:
        fs.check(state, det_xy[0], det_info[0], det_valid[0])
        if use_gsff:
            gsff_ops.check(gsff_gains, gsff_n_i, gsff_n_f, state['gsff'])
            if state['gsff']['buf'].shape[0] != v * s:
                raise ValueError('run_tracker_scan: the GSFF state has {} '
                                 'slots, the table {}'.format(
                                     state['gsff']['buf'].shape[0], v * s))
    out = fs.allocate(state, c, t_len)
    for t in range(t_len):
        state, _ = _tracker_frame_update(
            state, det_xy[t], det_info[t], det_valid[t],
            max_disappeared=max_disappeared, use_gsff=use_gsff,
            gsff_gains=gsff_gains, gsff_n_i=gsff_n_i, gsff_n_f=gsff_n_f,
            gsff_n_i0=gsff_n_i0, assign_mesh=assign_mesh, out=out, frame=t)
    emissions = dict(out['emission'])
    if use_gsff:
        state['gsff'] = {k: x.unflatten(0, (v, s))
                         for k, x in state['gsff'].items()}
    if not batched:
        state = shd._tree_map(lambda x: x[0], state)
        emissions = {k: x[0] for k, x in emissions.items()}
    return state, emissions


def compact_emissions_device(emissions, n_components, *, bucket):
    """Each frame's live slots packed into ONE (T, bucket+1, 5+K) int32
    buffer, bit for bit the JAX function's.

    Layout: head ``[:, 0, 0]`` the frame's live count, ``[:, 0, 1]``
    n_components, ``[:, 0, 2]`` n_det (for the renumberer), zeros after;
    payload rows ``[:, 1:, 0]`` ids, ``[:, 1:, 1]`` det_col, ``[:, 1:,
    2:2+K]`` position bits, ``[:, 1:, 2+K:5+K]`` (w, h, angle) bits. A
    stable sort of the key (0 live, 1 dead) moves the live slots to the
    front in slot order; the float payloads are bit-cast into the int32
    buffer (every float32 bit pattern is a valid int32). Slots beyond
    ``bucket`` are dropped: the caller compares the counts against
    ``bucket`` and reads the padded emissions for a batch that overflows.

    :param emissions: the padded emissions of ``run_tracker_scan``
    :param n_components: (T,) int components per frame
    """
    mask = emissions['mask']
    i32 = torch.int32
    t = mask.shape[0]
    k = emissions['pos'].shape[2]
    key = torch.where(mask, torch.zeros((), dtype=i32, device=mask.device),
                      torch.ones((), dtype=i32, device=mask.device))
    order = torch.sort(key, dim=1, stable=True).indices[:, :bucket]
    payload = torch.cat([emissions['ids'][..., None].to(i32),
                         emissions['det_col'][..., None].to(i32),
                         emissions['pos'].contiguous().view(i32),
                         emissions['info'].contiguous().view(i32)], dim=2)
    payload = torch.gather(payload, 1,
                           order[..., None].expand(-1, -1, 5 + k))
    head = torch.zeros((t, 1, 5 + k), dtype=i32, device=mask.device)
    head[:, 0, 0] = mask.sum(dim=1, dtype=i32)
    head[:, 0, 1] = n_components.to(i32)
    head[:, 0, 2] = emissions['n_det'].to(i32)
    return torch.cat([head, payload], dim=1)
