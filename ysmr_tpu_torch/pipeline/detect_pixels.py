"""Detection on the run-length wire: run-graph labels, then either one
index per run (host rects) or the device rects.

Counterpart of the run-CC branch of
``ysmr_tpu/pipeline/detect_pixels.py::detect_from_pixels`` (``use_run_cc``):
the device labels components directly on the (T, R) run tables. Then

- with ``skip_rect`` and ``det_px_as_runs`` it returns one detection index
  per run, and the host measures the cv2-exact rects from the wire pixels
  it already holds;
- without ``skip_rect`` it measures on the device (``_stats_outputs_runs``:
  row-extreme tables, hull edges, the exact minimum-area rect and, with
  ``cv2_centers``, cv2's bit-exact f32 centers) and returns the detection
  tables the device tracker reads.

Every other branch of the JAX function raises here and names the ROADMAP
item that ports it.
"""

import torch

from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import run_cc as rcc


def detect_from_pixels(px_x, px_y, px_counts, px_marker, frame_valid, *, h,
                       w, double_threshold, max_det, max_bh, cc_iters,
                       include_luminosity=False, px_runs=None,
                       run_counts=None, expanded_f=None, use_run_cc=False,
                       return_det_px=False, skip_rect=False,
                       det_px_as_runs=False, cv2_centers=False):
    """Detection tables from the run wire (the JAX function's signature,
    its run-CC branch).

    :param px_runs: (T, R) int32 view of the uint32 run wire (bits 0..25
        start ``y*w+x``, bit 26 marker, bits 27..31 length 1..31)
    :param run_counts: (T,) int32 runs per frame
    :param frame_valid: (T,) bool
    :return: dict with ``det_valid`` (T, max_det) bool, ``n_components``
        (T,) int32 and ``cc_steps`` (T,) int32 (the frame's propagation
        converged iff cc_steps < cc_iters); with ``skip_rect`` also
        ``det_run_idx`` (T, R) int16 — the detection index of every run in
        cv2's contour order (-1 = dropped, background or beyond
        ``max_det``); without it ``det_xy`` (T, max_det, 2) and
        ``det_info`` (T, max_det, 3) float32 (w, h, angle)
    """
    if px_runs is None or not use_run_cc:
        raise NotImplementedError(
            'detect_from_pixels: the pixel wire and the whole-frame labeling '
            'are not ported (ROADMAP Queue 1 item 10)')
    if include_luminosity:
        raise NotImplementedError(
            'detect_from_pixels: luminosity is not ported (ROADMAP Queue 1 '
            'item 10)')
    if skip_rect and not (return_det_px and det_px_as_runs):
        raise NotImplementedError(
            'detect_from_pixels: only the per-run detection index is ported; '
            'the per-pixel det_px expansion is ROADMAP Queue 1 item 10')
    rc_eff = torch.where(frame_valid, run_counts.to(torch.int32),
                         torch.zeros_like(run_counts, dtype=torch.int32))
    cc_out = rcc.run_cc_components(px_runs, rc_eff, w=w,
                                   double_threshold=double_threshold,
                                   max_iters=cc_iters,
                                   sorted_runs=not skip_rect)
    n_components = cc_out['n_components']
    if not skip_rect:
        # cv2 enumerates contours in reverse raster order: reverse the ids
        comp_rev_s = torch.where(cc_out['s_comp'] >= 0,
                                 n_components[:, None] - 1 - cc_out['s_comp'],
                                 torch.full_like(cc_out['s_comp'], -1))
        out = _stats_outputs_runs(cc_out['s_start'], cc_out['s_len'],
                                  comp_rev_s, n_components, h=h, w=w,
                                  max_det=max_det, max_bh=max_bh,
                                  cv2_centers=cv2_centers)
        out['cc_steps'] = cc_out['cc_steps']
        return out
    run_comp = cc_out['run_comp']
    # a run is horizontally contiguous foreground, so every pixel of a run
    # belongs to one component and the per-run index carries the whole
    # per-pixel assignment (the host expands it against the run table it
    # encoded)
    comp_rev = n_components[:, None] - 1 - run_comp
    det_run = torch.where((run_comp >= 0) & (comp_rev < max_det), comp_rev,
                          torch.full_like(comp_rev, -1)).to(torch.int16)
    det_valid = torch.arange(max_det, dtype=torch.int32,
                             device=px_runs.device)[None, :] < \
        torch.clamp(n_components, max=max_det)[:, None]
    return {'det_run_idx': det_run, 'det_valid': det_valid,
            'n_components': n_components, 'cc_steps': cc_out['cc_steps']}


_CV2_TABLE_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y',
                   'corner_l', 'corner_r')


def _cv2_center_override(rect, tables, *, max_bh):
    """Replace rect centers with the bit-exact cv2 caliper centers
    (ops/cv2_centers.py) where derivable; exact centers elsewhere. Tables
    and rect hold the batch's components flattened into one leading axis,
    so this runs once per batch."""
    from ysmr_tpu_torch.ops.cv2_centers import (cv2_centers_from_tables,
                                                inv_sqrt_table)
    isq = inv_sqrt_table(lb._CV2_CENTER_MAX_EDGE_W, max_bh,
                         device=rect['cx'].device)
    ccx, ccy, cok = cv2_centers_from_tables(
        *(tables[k] for k in _CV2_TABLE_KEYS), isq, max_bh=max_bh)
    return dict(rect, cx=torch.where(cok, ccx, rect['cx']),
                cy=torch.where(cok, ccy, rect['cy']))


def _stats_outputs_runs(s_start, s_len, s_comp, n_components, *, h, w,
                        max_det, max_bh, cv2_centers=False):
    """Detect tail over component-sorted run tables (no luminosity): the
    stats, hull and exact rect of every component of the batch in one
    pass over (T*max_det, ...) tables."""
    tables = lb.component_stats_runs(s_start, s_len, s_comp, w=w, h=h,
                                     max_det=max_det, max_bh=max_bh,
                                     cv2_centers=cv2_centers)
    out = detections_from_tables(tables, s_start.shape[0], max_det=max_det,
                                 max_bh=max_bh, cv2_centers=cv2_centers)
    out['n_components'] = n_components
    return out


def detections_from_tables(tables, t, *, max_det, max_bh, cv2_centers=False):
    """The exact rect of every component of a batch from its stats tables
    (T*max_det, ...): ``det_xy`` (T, max_det, 2), ``det_info``
    (T, max_det, 3) [w, h, angle] float32, zero where ``det_valid``
    (T, max_det) is False. Shared by the run wire and frames mode."""
    rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                            edge_angles=tables['edge_angles'],
                            edge_valid=tables['edge_valid'],
                            edge_dx=tables['edge_dx'],
                            edge_dy=tables['edge_dy'])
    if cv2_centers:
        # the tracker's measurement stream becomes cv2's f32 caliper
        # center bit for bit; W/H/angle keep the exact decomposition
        rect = _cv2_center_override(rect, tables, max_bh=max_bh)
    det_valid = (tables['count'] > 0).view(t, max_det)
    zero = torch.zeros((), dtype=torch.float32, device=det_valid.device)
    det_xy = torch.stack([rect['cx'], rect['cy']], dim=-1).view(
        t, max_det, 2)
    det_info = torch.stack([rect['w'], rect['h'], rect['angle_deg']],
                           dim=-1).view(t, max_det, 3)
    return {'det_xy': torch.where(det_valid[..., None], det_xy, zero),
            'det_info': torch.where(det_valid[..., None], det_info, zero),
            'det_valid': det_valid}
