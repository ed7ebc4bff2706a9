"""Device-mesh parallelism for the tracking pipeline (PyTorch).

Counterpart of ``ysmr_tpu/parallel/sharding.py``, whose docstring sets out
the two modes: video-batch data parallelism (each device runs detection
and the tracker on its own videos, no collective on the hot path) and the
dense-scene assignment with the slots x detections distance matrix
row-sharded over the mesh (only the O(R) per-row minima cross between
devices).

Differences from the JAX module, all of representation:

- ``Mesh`` is a small class of this module: a numpy array of
  ``torch.device`` shaped by its axis names. It may list one device more
  than once, the counterpart of JAX's virtual CPU devices: the splits then
  run one after another on that device, on its current stream. That is
  how tier-1 runs them on the CPU and the smoke on one GPU.
- ``shard_map`` becomes a Python loop over this process's shards, each
  under its device's guard; a sharded array is the list of this
  process's blocks (``shard_videos``), one per local shard, in shard order.
- Across processes, ``torch.distributed`` replaces ``jax.distributed``:
  every process holds the same local layout, shard ``i`` belongs to rank
  ``i // (size / world)``, and the assignment's per-row minima are the
  only tensors that cross (``all_gather``: NCCL on CUDA, gloo on the CPU).
  A CUDA process puts its first ``size / world`` visible GPUs on the mesh
  (restrict them with ``CUDA_VISIBLE_DEVICES``).
- ``make_multi_video_step`` flattens each device's videos into one frame
  batch, so each detection kernel launches once per device step, and runs
  the tracker once over the device's videos (``run_tracker_scan`` with a
  leading video axis, the counterpart of ``jax.vmap(per_video)``), so the
  assign kernel launches once per frame of the step.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ysmr_tpu_torch.ops import assignment as asg
from ysmr_tpu_torch.ops.assign import row_min_argmin


class Mesh:
    """Devices laid out on named axes.

    :param devices: array (or nested sequence) of ``torch.device`` shaped
        by ``axis_names``; across processes the global layout, every
        process's devices in rank order
    :param axis_names: one name per axis of ``devices``
    :param rank: this process's rank, None outside ``torch.distributed``
    :param world: the number of processes, None outside it
    """

    def __init__(self, devices, axis_names, rank=None, world=None):
        self.devices = np.array(devices, dtype=object)
        if self.devices.ndim != len(axis_names):
            raise ValueError('{} axis names for a device array of shape '
                             '{}'.format(len(axis_names),
                                         self.devices.shape))
        self.axis_names = tuple(axis_names)
        self.rank, self.world = rank, world
        n_local = self.devices.size // (world or 1)
        first = (rank or 0) * n_local
        #: the flat shard indices this process runs, and their devices
        self.local_shards = list(range(first, first + n_local))
        self.local_devices = [torch.device(d) for d in
                              self.devices.flat[first:first + n_local]]

    @property
    def size(self):
        """Shards over the flattened axes, across all processes."""
        return self.devices.size

    def __repr__(self):
        return 'Mesh({}, {}, rank={}, world={})'.format(
            [str(d) for d in self.devices.flat], self.axis_names, self.rank,
            self.world)


def device_count(device_type):
    """Devices this process can put on a mesh of ``device_type``: the
    visible GPUs, or 1 for the CPU. ``make_mesh`` and the dense-assignment
    gate of ``track_bacteria`` read it here."""
    return torch.cuda.device_count() if device_type == 'cuda' else 1


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device='cuda'):
    """Join a multi-process ``torch.distributed`` group.

    Parameters default to the ``YSMR_DIST_COORDINATOR`` (host:port),
    ``YSMR_DIST_NPROCS`` and ``YSMR_DIST_PROCESS_ID`` environment
    variables. The backend is NCCL for a CUDA ``device`` and gloo for the
    CPU. Returns False when no coordinator is configured; idempotent once
    joined. A failed ``init_process_group`` raises.

    :return: True when the group is up
    """
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get('YSMR_DIST_COORDINATOR')
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = os.environ['YSMR_DIST_NPROCS']
    if process_id is None:
        process_id = os.environ['YSMR_DIST_PROCESS_ID']
    cuda = torch.device(device).type == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise RuntimeError('init_distributed: NCCL needs a CUDA device')
    dist.init_process_group('nccl' if cuda else 'gloo',
                            init_method='tcp://' + coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def make_mesh(n_devices=None, axis='videos', device='cuda'):
    """A 1-axis mesh over ``n_devices`` devices (all processes together).

    On ``cuda`` the first visible GPUs (raises when there are too few, or
    none); on ``cpu`` ``n_devices`` entries of the one CPU device. Without
    ``n_devices``, every device ``device_count`` reports. A configured
    ``torch.distributed`` group is joined first (``init_distributed``).
    """
    kind = torch.device(device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError('make_mesh: unsupported device {}'.format(device))
    if kind == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device available; pass device='cpu' for "
                           'a CPU mesh.')
    rank = world = None
    if init_distributed(device=kind):
        rank, world = dist.get_rank(), dist.get_world_size()
    n_local = device_count(kind)
    if n_devices is not None:
        if n_devices % (world or 1):
            raise ValueError('{} devices do not split over {} processes'
                             .format(n_devices, world))
        n_local = n_devices // (world or 1)
    if kind == 'cuda':
        if n_local > device_count('cuda') or n_local < 1:
            raise ValueError('Requested {} CUDA device(s) per process but '
                             '{} are visible'.format(n_local,
                                                     device_count('cuda')))
        local = [torch.device('cuda', i) for i in range(n_local)]
    else:
        local = [torch.device('cpu')] * n_local
    return Mesh(local * (world or 1), (axis,), rank, world)


def _guard(device):
    """The device's guard (current device and stream) while a shard runs."""
    return torch.cuda.device(device) if device.type == 'cuda' else \
        contextlib.nullcontext()


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_states(states):
    """Stack a list of tracker states (or emissions), nested dicts of
    tensors, along a new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *states)


def shard_videos(mesh, arr):
    """This process's blocks of a (V, ...) video-major array (numpy, a
    tensor, or a nested dict of them, such as a stacked tracker state):
    a list with one block per local shard, shard ``i`` holding videos
    ``[i * V / size, (i + 1) * V / size)`` on its device. V must be a
    multiple of ``mesh.size``."""
    if isinstance(arr, dict):
        blocks = {k: shard_videos(mesh, v) for k, v in arr.items()}
        return [{k: b[j] for k, b in blocks.items()}
                for j in range(len(mesh.local_shards))]
    t = torch.as_tensor(arr)
    v = t.shape[0]
    if v % mesh.size:
        raise ValueError('{} videos do not split over a {}-device mesh'
                         .format(v, mesh.size))
    per = v // mesh.size
    return [t[s * per:(s + 1) * per].to(d)
            for s, d in zip(mesh.local_shards, mesh.local_devices)]


def make_multi_video_step(mesh, *, detect_kwargs, tracker_kwargs):
    """Build the sharded detect + track step for a batch of videos.

    The returned callable maps ``(frames, frame_valid, tracker_state)``,
    each the ``shard_videos`` blocks of a (V, T, H, W, 3) uint8, a (V, T)
    bool and a tracker state with a leading V, to ``(new_state,
    emissions)`` in the same block layout, emissions (v_loc, T, ...) per
    block; besides the tracker's emissions they hold the per-frame
    component counts ``n_components`` (v_loc, T), so the host can warn
    about overflow. Build it once per run and call it per frame batch: the
    tracker state threads through.

    Per device the step flattens its videos to one (v_loc * T, H, W, 3)
    batch and runs ``detect.detect_adaptive`` once over it (each
    frames-mode kernel launches once per device step),
    folds the tables back to (v_loc, T, ...), then runs
    ``run_tracker_scan`` once over them and the device's stacked state (a
    frame step, and one assign launch, per frame for all v_loc videos;
    each video's bits those of its own scan). Every device
    is enqueued before the caller reads anything back. The step runs the
    adaptive modes only: mean-threshold mode does not batch (the caller
    runs it solo). Memory: one detect call holds v_loc * T frames: the BGR
    batch (217 MB at 64 frames of 1228x922), the mask and the markers (72
    MB each, bool), with luminosity the int32 gray (290 MB), then the int32
    labels (290 MB).
    """
    from ysmr_tpu_torch.pipeline import detect as det
    from ysmr_tpu_torch.pipeline import tracker as trk

    # the tracker's tensor arguments (the GSFF bank) on every device
    tkw_on = {}
    for d in mesh.local_devices:
        if d not in tkw_on:
            tkw_on[d] = {k: v.to(d) if torch.is_tensor(v) else v
                         for k, v in tracker_kwargs.items()}

    def per_device(frames, valid, state, tkw):
        v_loc, t = frames.shape[:2]
        flat = frames.reshape((v_loc * t,) + tuple(frames.shape[2:]))
        tables = det.detect_adaptive(flat, valid.reshape(-1),
                                     **detect_kwargs)
        tables = {k: v.reshape((v_loc, t) + tuple(v.shape[1:]))
                  for k, v in tables.items()}
        # one scan over the device's videos: a frame step (and one assign
        # launch) per frame for all v_loc of them, as jax.vmap(per_video)
        state, emissions = trk.run_tracker_scan(
            state, tables['det_xy'], tables['det_info'], tables['det_valid'],
            **tkw)
        emissions['n_components'] = tables['n_components']
        return state, emissions

    def step(frames, frame_valid, state):
        out = []
        for f, fv, st, d in zip(frames, frame_valid, state,
                                mesh.local_devices):
            with _guard(d):
                out.append(per_device(f, fv, st, tkw_on[d]))
        return [o[0] for o in out], [o[1] for o in out]

    return step


def sharded_row_min_argmin(mesh, obj_xy, obj_valid, det_xy, det_valid):
    """Each row's nearest valid detection with the distance rows sharded.

    The R rows split into ``mesh.size`` equal shards; each of this
    process's shards runs ``ops/assign.py::row_min_argmin`` on its device
    (the kernel on ``cuda``, the plain version on ``cpu``). The per-row
    ``(row_min, cand_col)`` come back to the device of ``obj_xy`` (the
    tracker's, the mesh's first), across processes through one
    ``all_gather`` of these O(R) vectors. The kernel works row by row, so
    the result has the unsharded call's bits.

    :param obj_xy: (R, K) float32, R divisible by ``mesh.size``; every
        process passes all R rows
    :param det_xy: (C, K) float32, replicated
    :return: (row_min (R,) float32, cand (R,) int32) in row order, as
        ``row_min_argmin`` returns them
    """
    r = obj_xy.shape[0]
    if r % mesh.size:
        raise ValueError('{} rows do not split over a {}-device mesh'.format(
            r, mesh.size))
    per = r // mesh.size
    home = obj_xy.device
    parts = []
    for s, d in zip(mesh.local_shards, mesh.local_devices):
        rows = slice(s * per, (s + 1) * per)
        with _guard(d):
            row_min, cand = row_min_argmin(
                obj_xy[rows].to(d).contiguous(), obj_valid[rows].to(d),
                det_xy.to(d), det_valid.to(d))
            # one int32 (2, per) block: the minima's bits and the columns
            parts.append(torch.stack([row_min.view(torch.int32), cand]))
    both = torch.cat([p.to(home) for p in parts], dim=1)
    if mesh.world is not None:
        gathered = [torch.empty_like(both) for _ in range(mesh.world)]
        dist.all_gather(gathered, both)
        both = torch.cat(gathered, dim=1)
    return both[0].view(torch.float32), both[1]


def sharded_greedy_assign(mesh, obj_xy, obj_valid, det_xy, det_valid):
    """Reference-exact greedy assignment with the distance rows sharded:
    ``sharded_row_min_argmin``, then the winner resolution
    (``greedy_assign_from_candidates``) on the device of ``obj_xy``.

    :return: same contract as ``assignment.greedy_assign``
    """
    row_min, cand = sharded_row_min_argmin(mesh, obj_xy, obj_valid, det_xy,
                                           det_valid)
    return asg.greedy_assign_from_candidates(row_min, cand, obj_valid,
                                             det_valid)
