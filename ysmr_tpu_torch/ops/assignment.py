"""Greedy nearest-neighbour assignment over padded slot tables (PyTorch).

Counterpart of ``ysmr_tpu/ops/assignment.py``, whose docstring sets out the
reference's association rule (tracker.py:151-217) and why the first-come
loop is one rank computation plus one per-column segment minimum.

The distance keeps XLA's bits on the CPU: ``jax.jit`` evaluates
``sqrt(sum(diff * diff))`` as ``sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx*dx)))``
(K = 3; K = 2 drops dz), and a two-rounding ``sqrt(dx*dx + dy*dy)``
differs on ~8% of pairs. ``ds.fma_f32`` reproduces each fma exactly.
"""

import torch

from ysmr_tpu_torch.ops.ds import fma_f32

#: distance of an invalid (row, column) pair; plain Python float of the
#: JAX module's np.float32(3e38)
BIG = 3.0e38

_F32 = torch.float32


def _distances(obj_xy, det_xy):
    """(R, C) float32 Euclidean distances in XLA's rounding order."""
    diff = obj_xy[:, None, :] - det_xy[None, :, :]
    d0 = diff[..., 0]
    acc = d0 * d0
    for q in range(1, diff.shape[-1]):
        dq = diff[..., q]
        acc = fma_f32(dq, dq, acc)
    # correctly rounded float32 sqrt (through float64, where the double
    # rounding is harmless); PyTorch's CPU float32 sqrt misses it on a
    # few inputs
    return torch.sqrt(acc.double()).to(_F32)


def pairwise_distances(obj_xy, obj_valid, det_xy, det_valid):
    """Euclidean distance matrix with invalid rows/cols pushed to +BIG.

    :param obj_xy: (R, K) float32 tracked positions (K = 2 or 3)
    :param det_xy: (C, K) float32 detections
    :return: (R, C) float32
    """
    d = _distances(obj_xy, det_xy)
    valid = obj_valid[:, None] & det_valid[None, :]
    return torch.where(valid, d, torch.full_like(d, BIG))


#: (row, column) pairs per chunk of the plain row_min_argmin
_CHUNK_PAIRS = 1 << 22


def _row_min_argmin_into(row_min, cand, obj_xy, obj_valid, det_xy,
                         det_valid):
    """One (R, K) x (C, K) problem into the (R,) outputs, which hold
    (BIG, 0) on entry."""
    cols = torch.nonzero(det_valid).flatten()
    rows = torch.nonzero(obj_valid).flatten()
    if cols.numel() == 0 or rows.numel() == 0:
        return
    det_v = det_xy[cols]
    step = max(1, _CHUNK_PAIRS // cols.numel())
    for s in range(0, rows.numel(), step):
        sel = rows[s:s + step]
        m, j = _distances(obj_xy[sel], det_v).min(dim=1)
        row_min[sel] = m
        cand[sel] = cols[j].to(torch.int32)


def row_min_argmin_plain(obj_xy, obj_valid, det_xy, det_valid):
    """Plain version of the ``csrc/assign.cu`` kernel:
    ``pairwise_distances`` followed by the row minimum and the first
    minimal column, over chunks of the valid rows and the valid columns
    only (invalid entries are BIG and never win, so the result is the
    same bits as the full matrix's). With a leading video axis, the same
    per video.

    :param obj_xy: (R, K) or (V, R, K) float32; obj_valid (R,) or (V, R)
    :param det_xy: (C, K) or (V, C, K) float32; det_valid (C,) or (V, C)
    :return: (row_min (R,) or (V, R) float32 — BIG for an invalid row or
        one with no valid detection; cand_col int32 of the same shape — 0
        in that case)
    """
    if obj_xy.dim() not in (2, 3) or det_xy.dim() != obj_xy.dim():
        raise ValueError('row_min_argmin: obj_xy and det_xy must both be '
                         '(R, K) / (C, K) or (V, R, K) / (V, C, K)')
    dev = obj_xy.device
    row_min = torch.full(obj_xy.shape[:-1], BIG, dtype=_F32, device=dev)
    cand = torch.zeros(obj_xy.shape[:-1], dtype=torch.int32, device=dev)
    if obj_xy.dim() == 2:
        _row_min_argmin_into(row_min, cand, obj_xy, obj_valid, det_xy,
                             det_valid)
    else:
        for v in range(obj_xy.shape[0]):
            _row_min_argmin_into(row_min[v], cand[v], obj_xy[v],
                                 obj_valid[v], det_xy[v], det_valid[v])
    return row_min, cand


def greedy_assign(distance_matrix, obj_valid, det_valid):
    """Reference-exact greedy matching from a full distance matrix.

    :return: dict with ``row_to_col`` (R,) int64 matched column or -1, and
        ``col_matched`` (C,) bool
    """
    row_min, cand_col = distance_matrix.min(dim=1)
    return greedy_assign_from_candidates(row_min, cand_col, obj_valid,
                                         det_valid)


def greedy_assign_from_candidates(row_min, cand_col, obj_valid, det_valid):
    """Greedy matching from per-row (min distance, argmin column), the
    only projections of the distance matrix the matcher reads; per video
    with a leading video axis ((V, R) candidates, (V, C) detections).

    :return: dict with ``row_to_col`` (R,) or (V, R) int64, ``col_matched``
        (C,) or (V, C) bool
    """
    if row_min.dim() == 1:
        out = greedy_assign_from_candidates(row_min[None], cand_col[None],
                                            obj_valid[None], det_valid[None])
        return {k: v[0] for k, v in out.items()}
    v, r = row_min.shape
    c = det_valid.shape[1]
    dev = row_min.device
    cand_col = cand_col.long()
    row_min = torch.where(obj_valid, row_min, torch.full_like(row_min, BIG))
    # rank = position in the stable sort by row minimum (ties keep row order)
    order = torch.argsort(row_min, dim=1, stable=True)
    rank = torch.empty((v, r), dtype=torch.long, device=dev).scatter_(
        1, order, torch.arange(r, device=dev).expand(v, r))
    claim_ok = obj_valid & torch.gather(det_valid, 1, cand_col)
    seg = torch.where(claim_ok, cand_col, torch.full_like(cand_col, c))
    # per video, the first claimant's rank of each column (column c: the
    # rows that claim nothing)
    winner_rank = torch.full((v, c + 1), r, dtype=torch.long, device=dev)
    winner_rank.scatter_reduce_(1, seg, torch.where(
        claim_ok, rank, torch.full_like(rank, r)), 'amin', include_self=True)
    matched = claim_ok & (rank == torch.gather(winner_rank, 1, cand_col))
    row_to_col = torch.where(matched, cand_col, torch.full_like(cand_col, -1))
    col_hit = torch.zeros((v, c + 1), dtype=torch.int32, device=dev)
    col_hit.scatter_reduce_(1, seg, matched.to(torch.int32), 'amax',
                            include_self=True)
    return {'row_to_col': row_to_col, 'col_matched': col_hit[:, :c] > 0}
