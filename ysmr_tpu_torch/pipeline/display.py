# Copied from ysmr_tpu/pipeline/display.py; only the import lines differ.
#!/usr/bin/env python3
"""Live display during tracking ('display video analysis').

Replicates the reference's per-frame preview (track_eval.py:306-363): blue
rotated bounding boxes around every detection, green track IDs + centroid
dots, an FPS overlay, shown in a '<file> unfiltered possible detections'
window; 'q' interrupts the run (same error semantics as a read failure,
track_eval.py:361-363). With 'debugging' also set, the threshold mask (and
double-threshold markers) are shown (track_eval.py:209-210, :265-271).

The batched pipeline displays one batch behind compute: frames are retained
by the reader when display is on, and drawn when the batch's detections and
track emissions are read back. Headless hosts (no GUI support in OpenCV)
disable the display with a warning on the first failed ``imshow``.
"""

import logging
import os

import numpy as np


class LiveDisplay:
    def __init__(self, video_path, settings, frame_height, frame_width):
        import sys
        self.logger = logging.getLogger('ysmr').getChild(__name__)
        self.name = os.path.basename(video_path)
        self.enabled = True
        self.interrupted = False
        self.show_masks = bool(settings.get('debugging'))
        self.h = frame_height
        self.w = frame_width
        # cv2's Qt backend aborts the process (uncatchable SIGABRT) when it
        # cannot reach an X/Wayland display — gate upfront instead
        if sys.platform.startswith('linux') and \
                not (os.environ.get('DISPLAY') or
                     os.environ.get('WAYLAND_DISPLAY')):
            self.enabled = False
            self.logger.warning(
                "'display video analysis' requested but no GUI display is "
                "available (DISPLAY unset); continuing without the live "
                "preview. Use 'save video' / annotate_video() to inspect "
                'detections.')

    def show_batch(self, frames, count, det_host, emissions_host, fps):
        """Draw + show every valid frame of a read-back batch.

        :param frames: (B, H, W, 3) or (B, H, W) uint8, or None (no retained
            frames — frames mode streams them to the device; a black canvas
            is drawn on instead)
        :param det_host: dict with det_xy (B, D, >=2), det_info (B, D, 3),
            det_valid (B, D) numpy arrays, plus optional px_x/px_y/px_marker/
            count for the mask windows
        :param emissions_host: dict with mask (T, S), ids (T, S), pos (T, S, d)
        :param fps: current analysis throughput for the overlay
        """
        if not self.enabled or self.interrupted:
            return
        import cv2
        for t in range(count):
            if frames is None:
                frame = np.zeros((self.h, self.w, 3), np.uint8)
            else:
                frame = frames[t]
                if frame.ndim == 2:
                    frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
                else:
                    frame = frame.copy()
            valid = det_host['det_valid'][t]
            xy = det_host['det_xy'][t]
            info = det_host['det_info'][t]
            for d in np.nonzero(valid)[0]:
                box = np.intp(cv2.boxPoints((
                    (float(xy[d, 0]), float(xy[d, 1])),
                    (float(info[d, 0]), float(info[d, 1])),
                    float(info[d, 2]))))
                cv2.drawContours(frame, [box], -1, (255, 0, 0), 0)
            emit = emissions_host['mask'][t]
            ids = emissions_host['ids'][t]
            pos = emissions_host['pos'][t]
            for s in np.nonzero(emit)[0]:
                cx, cy = int(pos[s, 0]), int(pos[s, 1])
                cv2.putText(frame, '{}'.format(int(ids[s])),
                            (cx - 10, cy - 10), cv2.FONT_HERSHEY_SIMPLEX,
                            0.3, (0, 255, 0), 0)
                cv2.circle(frame, (cx, cy), 0, (0, 255, 0), -1)
            cv2.putText(frame, 'FPS: {}'.format(int(fps)), (100, 50),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.75, (50, 50, 170), 2)
            try:
                cv2.imshow('{} unfiltered possible detections'.format(
                    self.name), frame)
                if self.show_masks and ('px_x' in det_host or
                                        'px_packed' in det_host):
                    self._show_masks(cv2, det_host, t)
                if cv2.waitKey(1) & 0xFF == ord('q'):
                    self.interrupted = True
                    return
            except cv2.error as err:
                self.enabled = False
                self.logger.warning(
                    'Live display unavailable (headless OpenCV?): %s', err)
                return

    def _show_masks(self, cv2, det_host, t):
        n = int(det_host['count'][t])
        if 'px_packed' in det_host:
            packed = det_host['px_packed'][t][:n]
            lin = (packed & 0x7FFFFFFF).astype(np.int64)
            xs = (lin % self.w).astype(np.int64)
            ys = lin // self.w
            marker_t = (packed >> 31).astype(np.uint8)
        else:
            xs = det_host['px_x'][t][:n].astype(np.int64)
            ys = det_host['px_y'][t][:n].astype(np.int64)
            marker = det_host.get('px_marker')
            marker_t = marker[t][:n] if marker is not None else None
        mask = np.zeros((self.h, self.w), np.uint8)
        mask[ys, xs] = 255
        # in adaptive-double mode these are the host-side pre-propagation
        # foreground pixels; components later pruned by the device marker
        # reconstruction still appear here (the reference's 'threshold'
        # window shows the post-propagation mask, track_eval.py:270)
        window = 'threshold (pre-propagation)' if marker_t is not None \
            else 'threshold'
        cv2.imshow(window, mask)
        if marker_t is not None and (marker_t > 0).any():
            mmask = np.zeros((self.h, self.w), np.uint8)
            keep = marker_t > 0
            mmask[ys[keep], xs[keep]] = 255
            cv2.imshow('Adaptive double threshold markers', mmask)

    def close(self):
        if not self.enabled:
            return
        try:
            import cv2
            cv2.destroyAllWindows()
        except Exception:
            pass
