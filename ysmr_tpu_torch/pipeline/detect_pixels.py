"""Detection on the run-length wire: run-graph labels, one index per run.

Counterpart of the run-CC branch of
``ysmr_tpu/pipeline/detect_pixels.py::detect_from_pixels`` (``use_run_cc``
with ``skip_rect`` and ``det_px_as_runs``): the device labels components
directly on the (T, R) run tables and returns one detection index per run;
the host measures the cv2-exact rects from the wire pixels it already holds.
Every other branch of the JAX function raises here and names the ROADMAP
item that ports it.
"""

import torch

from ysmr_tpu_torch.ops import run_cc as rcc


def detect_from_pixels(px_x, px_y, px_counts, px_marker, frame_valid, *, h,
                       w, double_threshold, max_det, max_bh, cc_iters,
                       include_luminosity=False, px_runs=None,
                       run_counts=None, expanded_f=None, use_run_cc=False,
                       return_det_px=False, skip_rect=False,
                       det_px_as_runs=False):
    """Detection tables from the run wire (the JAX function's signature,
    one branch).

    :param px_runs: (T, R) int32 view of the uint32 run wire (bits 0..25
        start ``y*w+x``, bit 26 marker, bits 27..31 length 1..31)
    :param run_counts: (T,) int32 runs per frame
    :param frame_valid: (T,) bool
    :return: dict with ``det_run_idx`` (T, R) int16 — the detection index of
        every run in cv2's contour order (-1 = dropped, background or beyond
        ``max_det``) — ``det_valid`` (T, max_det) bool, ``n_components``
        (T,) int32, and ``cc_steps`` (T,) int32 (the frame's propagation
        converged iff cc_steps < cc_iters). The zero ``det_xy``/``det_info``
        tables of the JAX branch feed only the device tracker and are not
        returned.
    """
    if px_runs is None or not use_run_cc:
        raise NotImplementedError(
            'detect_from_pixels: the pixel wire and the whole-frame labeling '
            'are not ported (ROADMAP Queue 1 item 10)')
    if include_luminosity:
        raise NotImplementedError(
            'detect_from_pixels: luminosity is not ported (ROADMAP Queue 1 '
            'item 10)')
    if not skip_rect:
        raise NotImplementedError(
            'detect_from_pixels: device rects and stats are not ported '
            '(ROADMAP Queue 1 item 7)')
    if not (return_det_px and det_px_as_runs):
        raise NotImplementedError(
            'detect_from_pixels: only the per-run detection index is ported; '
            'the per-pixel det_px expansion is ROADMAP Queue 1 item 10')
    rc_eff = torch.where(frame_valid, run_counts.to(torch.int32),
                         torch.zeros_like(run_counts, dtype=torch.int32))
    cc_out = rcc.run_cc_components(px_runs, rc_eff, w=w,
                                   double_threshold=double_threshold,
                                   max_iters=cc_iters)
    n_components = cc_out['n_components']
    run_comp = cc_out['run_comp']
    # cv2 enumerates contours in reverse raster order: reverse the ids. A run
    # is horizontally contiguous foreground, so every pixel of a run belongs
    # to one component and the per-run index carries the whole per-pixel
    # assignment (the host expands it against the run table it encoded).
    comp_rev = n_components[:, None] - 1 - run_comp
    det_run = torch.where((run_comp >= 0) & (comp_rev < max_det), comp_rev,
                          torch.full_like(comp_rev, -1)).to(torch.int16)
    det_valid = torch.arange(max_det, dtype=torch.int32,
                             device=px_runs.device)[None, :] < \
        torch.clamp(n_components, max=max_det)[:, None]
    return {'det_run_idx': det_run, 'det_valid': det_valid,
            'n_components': n_components, 'cc_steps': cc_out['cc_steps']}
