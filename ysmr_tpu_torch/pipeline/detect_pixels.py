"""Detection from per-frame foreground-pixel wires: run-graph labels on the
run wire, or the pixel-table branch with per-pixel labels.

Counterpart of ``ysmr_tpu/pipeline/detect_pixels.py::detect_from_pixels``:

- the run-CC branch (``use_run_cc`` on the run wire, no luminosity): the
  device labels components directly on the (T, R) run tables, then with
  ``return_det_px`` returns one detection index per run
  (``det_px_as_runs``; the host measures the cv2-exact rects from the wire
  pixels it holds) or per wire pixel (``run_cc.det_px_from_runs``), and
  without ``skip_rect`` measures on the device (``_stats_outputs_runs``:
  the row-extreme tables, which run-CC's finish writes, hull edges, the
  exact minimum-area rect and, with ``cv2_centers``, cv2's bit-exact f32
  centers); the host-rect path of ``track_bacteria`` passes
  ``readback_runs`` instead and gets the one int16 plane it copies to the
  host (the per-run indices, the count and the steps), which run-CC's
  finish writes;
- the pixel-table branch (``run cc = off``, ``wire format = pixels``, and
  luminosity, which bypasses run CC): the wire is decoded to (T, F) pixel
  tables (the run wire expanded by ``ops/run_cc.py::expand_runs``,
  ``csrc/expand_runs.cu`` on the card; the packed uint32 wire; or the
  split int16/uint8 wire of luminosity), labelled by ``ops/cc.py::
  cc_labels_at_pixels`` (the CUDA kernel on the card; the JAX CPU path
  computes the same function with two whole-frame labelings) or, with
  ``use_table`` (``use table cc``), by ``ops/cc.py::cc_labels_table``
  (the sparse table CC, ``csrc/table_cc.cu`` on the card: the wire's
  valid prefix is in raster order, so it skips the sort), then
  finished by ``ops/cc.py::pixel_finish`` (``csrc/pixel_finish.cu`` on the
  card): the dense ids in wire order and, as asked, the int16 plane the
  host-rect path copies (``readback_pixels``), the ids themselves (returned
  per pixel as ``det_px_idx``) or the row tables of the device rects
  (``_stats_outputs``, with the exact rect luminosity); the pixel-mean
  luminosity takes the ids to ``labeling.component_stats``.

``use_table`` takes effect on the pixel-table branch only: the run-CC
branch ignores it, as ``ysmr_tpu``'s returns before it. Not ported: the
sorted-run compaction of the TPU path (a layout for the TPU, same
outputs).
"""

import torch

from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import run_cc as rcc
from ysmr_tpu_torch.ops.luminosity import HUNDREDTH

_I32 = torch.int32


def detect_from_pixels(px_x, px_y, px_counts, px_marker, frame_valid, *, h,
                       w, double_threshold, max_det, max_bh, cc_iters,
                       include_luminosity=False, px_gray=None, lum_win=48,
                       gray_frames=None, use_table=False, px_packed=None,
                       return_det_px=False, skip_rect=False, px_runs=None,
                       run_counts=None, expanded_f=None, use_run_cc=False,
                       det_px_as_runs=False, cv2_centers=False,
                       readback_runs=None, readback_pixels=None):
    """Detection tables from a batch's pixel wire (the JAX function's
    signature, without ``use_pallas``).

    :param px_x, px_y: (T, F) int16/int32 pixel coordinates in raster
        order, or None with ``px_packed`` or ``px_runs``
    :param px_counts: (T,) int32 valid pixels per frame (the pixel-table
        branch; unused on the run-CC branch)
    :param px_marker: (T, F) bool/uint8 stricter-threshold membership
    :param frame_valid: (T,) bool
    :param px_gray: optional (T, F) int gray values at the pixels (the
        pixel-mean luminosity without full frames)
    :param gray_frames: optional (T, H, W) uint8 gray frames; with
        ``include_luminosity`` the ILLUMINATION value is the exact
        filled-rotated-rect mean (``ops/luminosity.py``)
    :param use_table: label the pixel-table branch with the sparse table
        CC (``use table cc``; ``cc.cc_labels_table``) in place of
        ``cc.cc_labels_at_pixels``: the same labels wherever ``ysmr_tpu``'s
        table labeling converges; the run-CC branch ignores it
    :param px_packed: optional (T, F) int32 view of the uint32 packed wire
        (bits 0..30 ``y*w+x``, bit 31 marker)
    :param px_runs: optional (T, R) int32 view of the uint32 run wire (bits
        0..25 start ``y*w+x``, bit 26 marker, bits 27..31 length 1..31),
        with ``run_counts`` (T,) and ``expanded_f`` (the pixel-table width)
    :param return_det_px: also return ``det_px_idx`` (T, F) int16, the
        detection index of every wire-order pixel (-1 = background, dropped
        or beyond ``max_det``), or with ``det_px_as_runs`` on the run-CC
        branch ``det_run_idx`` (T, R) int16, one index per run
    :param skip_rect: return no device rects (``det_xy``/``det_info``
        zeros; ``det_xy`` (T, max_det, 3) with the pixel-mean luminosity);
        ignored when the exact rect luminosity needs the device rect
    :param readback_runs: None, or on the run-CC branch the host-rect
        batch's read-back width: return only ``readback`` (T,
        readback_runs + 2) int16 (``ops/run_cc.py::readback_plane``: the
        first runs' ``det_run_idx``, the clamped count, the steps), which
        run-CC's finish writes, with ``n_components`` and ``cc_steps``;
        the other output flags are then ignored
    :param readback_pixels: None, or on the pixel-table branch without
        luminosity's device rects the host-rect batch's read-back width:
        return only ``readback`` (T, readback_pixels + 2) int16
        (``ops/cc.py::pixel_finish``: the first pixels' ``det_px_idx``,
        the clamped count, 0), with ``n_components`` and ``cc_steps``
    :return: dict with ``det_xy`` (T, max_det, K) (K = 3 with luminosity),
        ``det_info`` (T, max_det, 3) [w, h, angle], ``det_valid``
        (T, max_det), ``n_components`` (T,) int32 and ``cc_steps`` (T,)
        int32 (the run-CC propagation's steps; 0 on the pixel-table branch,
        whose kernel has no cap), plus ``det_px_idx`` or ``det_run_idx`` as
        asked
    """
    if px_runs is not None and use_run_cc and not include_luminosity:
        return _detect_run_cc(px_runs, run_counts, frame_valid, h=h, w=w,
                              double_threshold=double_threshold,
                              max_det=max_det, max_bh=max_bh,
                              cc_iters=cc_iters, expanded_f=expanded_f,
                              return_det_px=return_det_px,
                              skip_rect=skip_rect,
                              det_px_as_runs=det_px_as_runs,
                              cv2_centers=cv2_centers,
                              readback_runs=readback_runs)
    if readback_runs is not None:
        raise ValueError('detect_from_pixels: readback_runs needs the run '
                         'wire with use_run_cc and no luminosity')
    exact_lum = include_luminosity and gray_frames is not None
    lin_raw = None
    if px_runs is not None or px_packed is not None:
        if px_runs is not None:
            lin_raw, px_marker = rcc.expand_runs(
                px_runs.to(_I32), run_counts.to(_I32), expanded_f,
                double_threshold)
        else:
            packed = px_packed.to(_I32)
            lin_raw = packed & 0x7FFFFFFF
            px_marker = packed < 0                    # bit 31
        px_y = torch.div(lin_raw, w, rounding_mode='floor')
        px_x = lin_raw - px_y * w
    else:
        px_x = px_x.to(_I32)
        px_y = px_y.to(_I32)
        px_marker = px_marker.to(_I32) > 0
    px_x, px_y = px_x.contiguous(), px_y.contiguous()
    t, f = px_x.shape
    dev = px_x.device
    iota_f = torch.arange(f, dtype=_I32, device=dev)[None, :]
    valid = ((iota_f < px_counts.to(_I32)[:, None]) &
             frame_valid[:, None]).contiguous()
    # the pixel kernel has no step count; made here, so that nothing runs
    # between the labels, the finish and what reads the finish
    cc_steps = torch.zeros((t,), dtype=_I32, device=dev)
    if use_table:
        lin = lin_raw if lin_raw is not None else px_y * w + px_x
        lab_fg, keep = cc.cc_labels_table(
            lin.contiguous(), valid, px_marker.contiguous(), h=h, w=w,
            double_threshold=double_threshold, max_iters=cc_iters,
            raster_prefix=True)
    else:
        lab_fg, keep = cc.cc_labels_at_pixels(
            px_x, px_y, valid, px_marker.contiguous(), h=h, w=w,
            double_threshold=double_threshold, max_iters=cc_iters)
    finish = dict(h=h, w=w)
    if readback_pixels is not None:
        # the host-rect batch: the finish writes what the host reads
        out = cc.pixel_finish(
            lab_fg, keep, px_x, px_y, valid,
            readback=dict(f=readback_pixels, max_det=max_det), **finish)
        out['cc_steps'] = cc_steps
        return out
    pixel_lum = include_luminosity and not exact_lum
    tables = not pixel_lum and (exact_lum or not skip_rect)
    fin = cc.pixel_finish(
        lab_fg, keep, px_x, px_y, valid, ids=return_det_px or pixel_lum,
        row_tables=dict(max_det=max_det, max_bh=max_bh) if tables else None,
        **finish)
    n_components = fin['n_components']
    if tables:
        out = _stats_outputs(fin, t, max_det=max_det, max_bh=max_bh,
                             gray_frames=gray_frames if exact_lum else None,
                             lum_win=lum_win, cv2_centers=cv2_centers)
    elif not pixel_lum or skip_rect:
        # the host measures the rects; dense ids make slot validity an
        # iota compare
        det_valid = torch.arange(max_det, dtype=_I32, device=dev)[None, :] < \
            torch.clamp(n_components, max=max_det)[:, None]
        if pixel_lum:
            count, lum_sum = lb.component_sums(
                _seg(fin['comp'], keep, max_det), keep,
                _gray_in(px_gray, px_x), max_det=max_det)
            lum = lum_sum.to(torch.float32) / \
                torch.clamp(count, min=1) * HUNDREDTH
            zero = torch.zeros_like(lum)
            det_xy = torch.where(det_valid[..., None],
                                 torch.stack([zero, zero, lum], dim=-1), 0.0)
        else:
            det_xy = torch.zeros((t, max_det, 2), dtype=torch.float32,
                                 device=dev)
        out = {'det_xy': det_xy,
               'det_info': torch.zeros((t, max_det, 3), dtype=torch.float32,
                                       device=dev),
               'det_valid': det_valid, 'n_components': n_components}
    else:
        out = _pixel_mean_outputs(_seg(fin['comp'], keep, max_det), keep,
                                  px_x, px_y, _gray_in(px_gray, px_x),
                                  max_det=max_det, max_bh=max_bh,
                                  cv2_centers=cv2_centers)
        out['n_components'] = n_components
    out['cc_steps'] = cc_steps
    if return_det_px:
        comp = fin['comp']
        out['det_px_idx'] = torch.where(keep & (comp < max_det), comp,
                                        torch.full_like(comp, -1)).to(
                                            torch.int16)
    return out


def _seg(comp, keep, max_det):
    """Dense ids as segment keys: ``max_det`` off the kept pixels and
    beyond capacity."""
    return torch.where(keep, torch.clamp(comp, max=max_det),
                       torch.full_like(comp, max_det))


def _gray_in(px_gray, px_x):
    """The per-pixel gray of the pixel-mean luminosity (0 without it)."""
    return px_gray.to(_I32) if px_gray is not None else \
        torch.zeros_like(px_x)


def _detect_run_cc(px_runs, run_counts, frame_valid, *, h, w,
                   double_threshold, max_det, max_bh, cc_iters, expanded_f,
                   return_det_px, skip_rect, det_px_as_runs, cv2_centers,
                   readback_runs):
    """The run-CC branch: labels on the run tables (``ops/run_cc.py``)."""
    kw = dict(w=w, double_threshold=double_threshold, max_iters=cc_iters,
              frame_valid=frame_valid)
    if readback_runs is not None:
        # the host-rect batch: run-CC's finish writes what the host reads
        cc_out = rcc.run_cc_components(
            px_runs, run_counts,
            readback=dict(runs=readback_runs, max_det=max_det), **kw)
        return {k: cc_out[k] for k in ('readback', 'n_components',
                                       'cc_steps')}
    row_tables = None if skip_rect else dict(h=h, max_det=max_det,
                                             max_bh=max_bh)
    cc_out = rcc.run_cc_components(px_runs, run_counts,
                                   row_tables=row_tables, **kw)
    n_components = cc_out['n_components']
    det_px = det_run = None
    if return_det_px:
        det_idx = rcc.detection_index(cc_out['run_comp'], n_components,
                                      max_det)
        if det_px_as_runs:
            # a run is horizontally contiguous foreground, so every pixel
            # of a run belongs to one component and the per-run index
            # carries the whole per-pixel assignment (the host expands it
            # against the run table it encoded)
            det_run = det_idx.to(torch.int16)
        else:
            rc_eff = torch.where(frame_valid, run_counts.to(_I32),
                                 torch.zeros_like(run_counts, dtype=_I32))
            det_px = rcc.det_px_from_runs(px_runs, rc_eff, det_idx,
                                          f=expanded_f,
                                          max_det=max_det).to(torch.int16)
    if not skip_rect:
        out = _stats_outputs_runs(cc_out, px_runs.shape[0], max_det=max_det,
                                  max_bh=max_bh, cv2_centers=cv2_centers)
    else:
        t = px_runs.shape[0]
        dev = px_runs.device
        out = {'det_xy': torch.zeros((t, max_det, 2), dtype=torch.float32,
                                     device=dev),
               'det_info': torch.zeros((t, max_det, 3), dtype=torch.float32,
                                       device=dev),
               'det_valid': torch.arange(max_det, dtype=_I32,
                                         device=dev)[None, :] <
               torch.clamp(n_components, max=max_det)[:, None],
               'n_components': n_components}
        if det_run is not None:
            out['det_run_idx'] = det_run
    if det_px is not None:
        out['det_px_idx'] = det_px
    out['cc_steps'] = cc_out['cc_steps']
    return out


_CV2_TABLE_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y',
                   'corner_l', 'corner_r')


def _cv2_center_override(rect, tables, *, max_bh):
    """Replace rect centers with the bit-exact cv2 caliper centers
    (ops/cv2_centers.py) where derivable; exact centers elsewhere. Tables
    and rect hold the batch's components flattened into one leading axis,
    so this runs once per batch."""
    from ysmr_tpu_torch.ops.cv2_centers import (cv2_centers_from_tables,
                                                inv_sqrt_table_cached)
    isq = inv_sqrt_table_cached(lb._CV2_CENTER_MAX_EDGE_W, max_bh,
                                rect['cx'].device)
    ccx, ccy, cok = cv2_centers_from_tables(
        *(tables[k] for k in _CV2_TABLE_KEYS), isq, max_bh=max_bh)
    return dict(rect, cx=torch.where(cok, ccx, rect['cx']),
                cy=torch.where(cok, ccy, rect['cy']))


def _stats_outputs_runs(cc_out, t, *, max_det, max_bh, cv2_centers=False):
    """Detect tail over run-CC's row tables (``run_cc_components`` with
    ``row_tables``; no luminosity): the stats, hull and exact rect of every
    component of the batch in one pass over (T*max_det, ...) tables."""
    tables = lb._stats_tail_from_tables(*(cc_out[k] for k in rcc.TABLE_KEYS))
    out = detections_from_tables(tables, t, max_det=max_det, max_bh=max_bh,
                                 cv2_centers=cv2_centers)
    out['n_components'] = cc_out['n_components']
    return out


def _stats_outputs(fin, t, *, max_det, max_bh, gray_frames, lum_win,
                   cv2_centers=False):
    """Detect tail over the pixel finish's row tables (``pixel_finish``
    with ``row_tables``): the stats, hull and exact rect of every
    component of the batch and, with ``gray_frames``, the exact rect mean
    of the gray frames."""
    tables = lb._stats_tail_from_tables(*(fin[k] for k in cc.TABLE_KEYS))
    return detections_from_tables(
        tables, t, max_det=max_det, max_bh=max_bh, cv2_centers=cv2_centers,
        n_components=fin['n_components'], gray_frames=gray_frames,
        lum_win=lum_win)


def _pixel_mean_outputs(seg, keep, px_x, px_y, gray_in, *, max_det, max_bh,
                        cv2_centers=False):
    """Detect tail over (T, F) pixel tables (``seg`` = dense id,
    ``max_det`` on the background) with the pixel-mean luminosity of
    ``gray_in`` (no gray frames): stats, hull and exact rect."""
    tables = lb.component_stats(px_x, px_y, seg, keep, gray_vals=gray_in,
                                max_det=max_det, max_bh=max_bh)
    lum = (tables['lum_sum'].to(torch.float32) /
           torch.clamp(tables['count'], min=1) * HUNDREDTH).view(
               seg.shape[0], max_det)
    return detections_from_tables(tables, seg.shape[0], max_det=max_det,
                                  max_bh=max_bh, cv2_centers=cv2_centers,
                                  lum=lum)


def detections_from_tables(tables, t, *, max_det, max_bh, cv2_centers=False,
                           n_components=None, gray_frames=None, lum=None,
                           lum_win=48):
    """The exact rect of every component of a batch from its stats tables
    (T*max_det, ...): ``det_xy`` (T, max_det, 2), ``det_info``
    (T, max_det, 3) [w, h, angle] float32, zero where ``det_valid``
    (T, max_det) is False. With ``gray_frames`` (T, H, W) the third
    ``det_xy`` column is the exact rect luminosity, taken at the exact
    center before the cv2-center override, as in JAX; with ``lum``
    (T, max_det) it is that. Shared by the run wire, the pixel tables and
    frames mode."""
    rect = lb.rect_from_tables(tables)
    det_valid = (tables['count'] > 0).view(t, max_det)
    if gray_frames is not None:
        from ysmr_tpu_torch.ops.luminosity import rect_mean_luminosity
        lum = rect_mean_luminosity(
            gray_frames, *(rect[k].view(t, max_det) for k in
                           ('cx', 'cy', 'w', 'h', 'angle_deg')),
            det_valid, win=lum_win)
    if cv2_centers:
        # the tracker's measurement stream becomes cv2's f32 caliper
        # center bit for bit; W/H/angle keep the exact decomposition
        rect = _cv2_center_override(rect, tables, max_bh=max_bh)
    zero = torch.zeros((), dtype=torch.float32, device=det_valid.device)
    xy = [rect['cx'].view(t, max_det), rect['cy'].view(t, max_det)]
    if lum is not None:
        xy.append(lum)
    det_xy = torch.stack(xy, dim=-1)
    det_info = torch.stack([rect['w'], rect['h'], rect['angle_deg']],
                           dim=-1).view(t, max_det, 3)
    out = {'det_xy': torch.where(det_valid[..., None], det_xy, zero),
           'det_info': torch.where(det_valid[..., None], det_info, zero),
           'det_valid': det_valid}
    if n_components is not None:
        out['n_components'] = n_components
    return out
