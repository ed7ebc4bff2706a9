#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (ysmr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device, ``nvcc`` and a C++ compiler; it builds what it runs from the
sources in the checkout (into ``ysmr_tpu_torch/.build/``). Phases:

1. environment: card name and power limit, torch and CUDA versions, the
   native host library that loaded (the committed one, or its build);
2. build of the CUDA kernel, timed;
3. kernel against its plain PyTorch version on the card: the run graphs of
   64 bench-sized frames (both the 4-connected marker reconstruction and
   the 8-connected labeling), those of the dense scene's first 64 frames
   (the run wire's R bucket, both propagations of the dense path) and
   seeded random graphs up to R = 131072 runs; labels must be equal,
   every frame must converge, and on a random init of the kernel's
   contract (every label names a run of its own component, random weak
   bits) the labels must be the component-wise minimum and the plain
   version's; median ms per batch of each;
4. the main path at real size: the bench scene (630 frames of 1228x922,
   200 rods, seed 123, drawn in memory) through the port's stage-1 loop on
   ``cuda`` and then on ``cpu``; the two ``_list.csv`` files must be
   byte-identical, and the kernel must have been launched on the ``cuda``
   run, run-CC's finish writing the readback plane once a batch;
5. the public entry point ``track_bacteria(path)`` on the bench clip
   written as MJPG (needs cv2), rows held against the committed reference
   list ``bench_data/bench_clip_list.csv.gz``;
6. the dense path's kernels (hull, sweep, assign) against their plain
   PyTorch versions on the card, outputs bit-equal: hull (from min_y,
   with count) and sweep (the row tables at the hull's strict corners,
   the edge candidates, (1, 0) implicit) on the tables of the dense
   scene's first batch and of the bench scene's first frames-mode batch
   (32768 x 64), each batch's share of corners logged and the corners'
   extents held to those of every valid point; the hull on seeded random
   tables (also with valid rows that are no prefix, and with R = 4000 and
   R above the kernel's shared-memory cap), the sweep on seeded random
   tables at R = 1, 17, 48, 65 and 96 (one to four directions a lane, two
   passes at K = 191),
   assign at 4096x4096 and 16384x16384 with K = 2 and 3 (invalid rows and
   columns, exact ties) and on the edge cases of its row tiles and column
   slices (4097x4095, 1x1, 700x63, ties across slices, all rows or all
   columns invalid); median ms of each;
7. the dense path at full width on ``cuda``: the dense scene (150 frames
   of 1228x922, 3000 rods, seed 125; bench.py ``measure_dense_e2e``) in
   memory through the stage-1 loop (stage split), then written as MJPG
   through ``track_bacteria(path)``: every kernel launched (the GSFF
   and frame-step kernels once per frame step, as the assign kernel;
   every detect batch's row tables written by run-CC's finish, as often
   as the hull ran, and the sweep as often; no candidate point built on
   the card), the track count
   within 2899 +- 10, no dropped registration, id agreement against
   ``bench_data/dense_clip_list.csv.gz`` printed;
8. ``cuda`` against ``cpu`` on the dense scene's first batch (64 frames)
   at dense capacities: run-CC through its kernels, the batch's row
   tables from its finish, no candidate point built on the card;
   TRACK_ID and POSITION_T identical, the other
   columns within the stated tolerance;
9. the frames-mode kernels (whole-frame labeling, 4- and 8-connected, and
   the marker reconstruction) against their plain PyTorch versions on the
   card, bit-equal: on the bench scene's first 64 frames thresholded by
   the port's device preprocess at 1228x922, and on seeded random blob
   masks with an all-background frame and a serpentine component far
   longer than 64 propagation steps, and on edge masks (a checkerboard,
   one-pixel diagonals, a word across two frames) (held to scipy, and to
   the plain version only where that converged); median ms of each; the
   edge masks at 921x1227 once more, a frame a launch, so that launches
   start off 16-byte boundaries (held to scipy);
10. frames mode (``transfer mode = frames``) at full width on ``cuda``:
   the bench scene in memory (stage split, frames/s), whose ``_list.csv``
   must be byte-identical to the pixels-mode device path's without cv2
   centers on the same frames; the dense scene in memory (stage split);
   the MJPG bench clip through ``track_bacteria(path)``; the MJPG dense
   clip through ``track_bacteria(path)`` (2899 +- 10 tracks, no dropped
   registration; the reference list is the clip's, so the gate is held on
   the clip), with every kernel of the path launched in each clip run
   and the compaction (``csrc/compact.cu``) one call a detect batch;
11. ``cuda`` against ``cpu`` in frames mode on the bench scene's first 16
   frames (a 64-frame batch takes over a minute on the cpu): TRACK_ID and
   POSITION_T identical, the other columns within the stated tolerance;
12. the pixel kernel (``cc_labels_at_pixels``) against its plain version
   (bit-equal where that converged), against the composition of the
   reconstruction and labeling kernels with a rasterize and a gather, and
   against scipy on every frame: the bench batch (64 x 8192, double and
   single threshold), the dense batch (64 x 131072), random blobs with
   the serpentine and lists that break the kernel's tiling (a run across
   a tile boundary, a component over five tiles, an empty frame, a full
   list, F no multiple of the tile); median ms of each and the bound;
13. the bench scene in memory with ``wire format = pixels`` and with ``run
   cc = off`` (the pixel-table branch): ``_list.csv`` byte-identical to
   the run-wire path's of phase 4, the pixel finish once a batch;
14. luminosity on the bench MJPG clip through ``track_bacteria(path)``
   with GSFF (host rects feeding the device tracker in 3-D), its first 64
   frames without GSFF (the float64 tracker): ILLUMINATION against cv2's
   recipe on 1500 sampled rows, the GSFF rows against the same
   detections' values; the scene in memory (stage split); ``cuda`` against
   ``cpu`` on 16 frames, byte-identical; in both clip runs the rect mean
   (``csrc/luminosity.cu``) once a host-rect finish and the pixel finish
   (``csrc/pixel_finish.cu``) once a batch;
15. luminosity on the dense clip (device rects and tracker), the
   ILLUMINATION check on the first batch's detections, the scene in
   memory (stage split), ``cuda`` against ``cpu`` on 16 frames, and the
   dense scene with the pixel wire byte-identical to the run wire's; the
   rect mean and the pixel finish once a batch in the clip run, the finish
   once a batch with the pixel wire;
16. frames-mode luminosity on the bench scene in memory (the rect mean
   once a batch, the pixel finish never), and ``cuda`` against ``cpu`` on
   16 frames, byte-identical;
17. dense exact mode: the dense capacities with ``cv2 exact rects max
   detections = 4096``, so the dense scene goes through run-CC on the
   card, the host rects and the float64 tracker: in memory (stage split),
   then the MJPG dense clip through ``track_bacteria(path)``, whose rows
   must be those of ``bench_data/dense_clip_list.csv.gz`` (378,751 rows,
   2899 tracks), with the run-CC kernel launched (its finish without the
   row tables) and the device rects' and tracker's kernels not;
18. the user's program: ``python -m ysmr_tpu_torch <bench clip> --serial``
   in a subprocess on ``cuda`` (``bench_settings()`` as a tracking.ini,
   the live display on in a headless environment, plots on), through a
   wrapper that replaces ``ysmr_tpu_torch.plot_functions`` with a stub
   that records each call (a GPU host may lack matplotlib), times each
   stage and counts the kernels' launches: exit 0, the run-CC kernel
   launched, ``_list.csv`` row-identical to the reference list, and
   ``_selected_data.csv``, ``_statistics.csv``, ``_analysed.csv`` and the
   collated xlsx cell for cell those of ``analyse()`` on the reference
   list through the CSV restart path (numbers within 1e-9; the cells that
   hold a displacement's direction are counted, not held: see
   ``DIRECTION_COLUMNS``); the wall time of each stage;
19. the live display on the card with a fake GUI (cv2's window calls
   replaced, ``DISPLAY`` set) on the bench clip: every frame drawn, the
   device-rect path's kernels launched, ``_list.csv`` byte-identical to
   the device-rect path without the display (batch 16 against 64), and
   'q' after the second batch returns None;
20. the compact emissions readback on the dense scene in memory against
   the padded readback (byte-identical; the bucket grows from 1024 to
   4096, the batches read padded and the stage split printed) and on the
   dense clip through ``track_bacteria(path)`` (byte-identical to phase
   7's list);
21. ``det_px_from_runs`` (the run-CC branch's per-pixel detection index)
   on ``cuda`` against ``cpu`` on the first bench batch;
22. the program's spawn pool on the card (``python -m ysmr_tpu_torch``
   without ``--serial``) on two 64-frame clips against ``--serial``: every
   CSV byte-identical;
23. the multi-video path on ``cuda`` (``track_videos_sharded``, frames
   mode, batch 16) over four full-width MJPG bench clips of uneven length
   (seeds 123, 126, 127, 128; 192, 160, 128 and 96 frames) and one
   640x480 clip (a second group): every ``_list.csv`` byte-identical to a
   solo ``track_bacteria(path)`` on ``cuda`` with the same settings,
   kernels 2-6, the fused preprocess and the compaction launched (the
   counts per device step printed), the assign kernel once per frame of
   a device step (the tracker batched over the step's videos: 16 steps x
   16 frames = 256), the GSFF and frame-step kernels as often, the fused
   preprocess and the compaction once per device step (16) and the int32
   adaptive mean never,
   the sharded run's wall time and frames/s beside the solo runs' sum;
24. the program with ``shard videos across devices`` in its tracking.ini:
   ``python -m ysmr_tpu_torch <phase 23's four clips> --serial`` and once
   without ``--serial``: exit 0, every clip's stage outputs, the lists
   byte-identical to phase 23's, and without ``--serial`` the log says
   that sharding replaced the pool and one process ran every stage;
25. the sharded assignment on the card: ``sharded_greedy_assign`` on
   meshes that list the card 1, 2 and 4 times at 16384 x 4096 (K = 2, 3)
   bit-equal to the unsharded matcher; ``run_tracker_scan(assign_mesh=
   ...)`` on the dense scene's first batch equal to the call without,
   the sharded candidates through the frame-step kernel (one launch a
   frame); the ``all_gather`` branch in a one-process NCCL group from
   ``init_distributed``; the dense-assignment gate of ``track_bacteria``
   shut on one card;
26. ``run_cc.keep_marked_runs`` through the kernel on the first bench batch
   bit-equal to its plain version, one step of
   ``graft_entry.entry('cuda')`` against ``entry('cpu')``, and
   ``graft_entry.dryrun_multichip(4)`` on ``cuda`` (its pipeline leg
   included: ``track_bacteria`` through the dense-assignment gate and
   ``track_videos_sharded`` on two tiny clips);
27. the tracker batched over the video axis: the batched assign kernel
   (one launch for V problems) bit-equal to its plain version and to V
   single launches (V = 4 at 1024 x 512 and 4096 x 4096, K = 2, 3, timed
   against the four single launches and ``torch.cdist(...).min(-1)`` over
   the batch; V = 5 at 1001 x 700 with an all-invalid video and one
   without a valid detection, V = 1, C = 0), then the dense scene's first
   batch split into four pseudo-videos of 16 frames: one batched
   ``run_tracker_scan`` on ``cuda`` bit-equal to the four per-video scans
   on ``cuda``, 16 assign launches against 64, as many frame-step
   launches as assign launches;
28. both entries of ``csrc/adaptive_mean.cu`` against their plain
   versions on the card, bit-equal. The int32 adaptive mean: the blurred
   first 64 frames of the bench and dense scenes, a 16-frame 640x480
   batch, and the edge shapes (1x1x1, 3x7x5, 17x33x129, 2x921x1227) with
   values in 0-255 and in +-70,000; median ms of the kernel, the plain
   version and the ``F.conv2d`` yardstick (TF32 off; timed, not
   bit-equal); its path, ``detect_from_blurred``, one launch, the tables
   those of ``detect_batch``. The fused preprocess
   (``adaptive_masks_from_bgr``: BGR in, mask and markers out): the same
   three batches as BGR, timed with and without the gray, both rules,
   white and dark, a padded batch, and the edge shapes (tiles crossed, 2
   rows, 2 columns, W % 4 != 0) with a padded frame; ms, bound and share
   of each, and each kernel's registers, shared memory and occupancy. The
   frames path's phases (10, 16, 23) fail unless the fused entry ran once
   a detect batch (phase 23: once a device step) and the int32 entry
   never;
29. the GSFF kernel (``csrc/gsff.cu``, the tracker's register fill and
   filter step) against its plain version on the card, bit-equal, one
   launch a call, its inputs untouched: every frame step's call of the
   dense scene's first batch (and the whole scan with the plain version
   swapped in, every emission and state tensor bit-equal), random mid-run
   states at N = 4096 and 4 x 1024, and the edge cases of
   ``tests/test_torch_gsff.py`` (N = 1 and 4095, all slots inactive, all
   registering, the n_max 256 / n_f 8 bank, +-1e4 px, n_max 33 and 64,
   whose trees start in the warp's shared buffer); median ms of the
   kernel and the plain version with the bound; then the dense frame
   step's kernels (``torch.profiler``) and wall time at V = 1 and V = 4,
   and with luminosity's K = 3 at V = 1
   (``tracker_step_launches.measure``), with the kernel and with the
   plain version swapped in, the device operations by name (at most 4
   kernels, memsets and copies with the kernels: the GSFF kernel writes
   the live slots' positions itself; each scan profiled
   until two of its profiles list the same operations). The dense, frames,
   luminosity and multi-video phases (7, 10, 14-16, 23, 24) fail unless
   it was launched;
30. the frame-step kernel (``csrc/frame_step.cu``: the tracker's greedy
   match, ageing, registration and emissions) against
   ``match_and_register_plain`` on the card, bit for bit, one call a
   check, its inputs untouched: every frame step of the dense first batch
   (the plain version's state fed to both, and the whole scan with the
   plain block swapped in), random states at the dense size (4096 slots,
   3000 live) for V = 1 and 4, and the edge cases of
   ``tests/test_torch_frame_step.py`` (its seven seeded cases at eight
   shapes, three of them splitting the rank tiles and the update cluster
   unevenly, NaN row minima, ``max_disappeared`` compared in float32, no
   slots, and ``frame_step_cases``' key edges: signed zeros, NaN
   payloads, ids at the int32 limits, keys equal but for the slot);
   median ms of each with the bound, and the rank and update launches'
   device times apart, each with its bound. Phases 7, 10, 14-16 and 23
   fail unless both were launched, 7 and 23 unless once a frame step;
31. the rect tail's kernels against their plain versions on the card, one
   launch a call: the cv2 centres (``csrc/cv2_centers.cu``; ``ok`` equal
   everywhere, the centres bit-equal where it holds), the hull-edge
   finish and the rect select (``csrc/rect.cu``, bit-equal; the rect
   select forms the (1, 0) candidate's direction), on the dense
   first batch's tables, the frames-mode bench batch and seeded edge
   cases (no valid row, a pixel, lines, more than 32 strict corners, more
   than 8 in-band candidates, bboxes past the inverse-sqrt table, equal
   areas and angles, a missing row, a component taller than R, random
   tables at R = 2, 48 and 96) and the cases that split the kernels'
   layouts unevenly (octagons with exactly 8 and 9 edges in the
   surrogate band, squares on the inverse-sqrt table's last entry and one
   past it, D no multiple of a block's components, tables too tall to
   stage at R = 1000; the rect select with every candidate valid, none,
   K = 1, 2, 127 and 191); median ms of each with the bound, and a
   ``rect tail resources`` JSON line a kernel (the sweep's too: ptxas'
   registers, spills and shared memory, the occupancy they allow, the
   profiler's estimate of achieved occupancy on the dense batch); then
   the dense first batch's ``_list.csv`` with the plain blocks (hull,
   sweep, edge finish, rect select, cv2 centres) swapped in,
   byte-identical to the kernels'. Phases 7 and 10 fail unless the sweep,
   edge finish and rect select ran once a detect batch, the cv2 centres
   once a batch on the dense clip and never in frames mode, and phases 7,
   8 and 10 if candidate points were built on the card;
32. the compaction and row tables of frames mode (``csrc/compact.cu``,
   ``labeling.compact_row_tables``) against their plain version
   (``compact_labels`` then ``component_row_tables``) on the card, bit
   for bit, one call a check: the bench batch, the dense scene's frames
   batch and a 16-frame 640x480 batch as frames mode's detect hands them
   over (the fused preprocess, the reconstruction and the labeling on the
   card), timed with the bound, the device time by kernel and the
   device span, reading the mask as the labeling packed it (as the detect
   does) and, untimed, the mask's bytes; and the seeded edge cases of
   ``compact_cases.py``, with the mask and packed (more
   components than max_det, a component taller than max_bh, empty
   frames, frames of one row and of one column, components on every frame
   edge and a full frame, frames under 32 pixels);
33. run-CC's steps around the propagations (``csrc/run_cc.cu``:
   ``run_cc.prepare_runs``, ``compact_kept_runs``, ``finish_components``)
   against their plain versions on the card, bit for bit on every output,
   one counted call each: prepare for both thresholds' dilations, with
   every frame valid and with frame 1 invalid (``frame_valid``), compact
   on the 4-connected labels, finish with and without the compaction, on
   the propagation's labels and after one step of it, without and with
   the row tables of the device rects (the path's capacities, one row,
   ids past max_det) and the host-rect readback plane (``stage_detect``'s
   width at the path's capacity, every run at 3 detections, one run), and
   ``run_cc_components`` through them against
   ``run_cc_components_plain``, on the bench and dense first batches
   (timed, the dense one with the dense path's row tables, the bench one
   with the plane: event span against the plain version, device time by
   kernel, device operations, the bound: the wire in and the outputs out
   once), phase 3's random graphs, the seeded cases of
   ``run_cc_cases.py`` (stale padding and a padded frame, a full table,
   runs at both edges, one row, no and all markers, one and two columns,
   runs of length 0 and out of raster order) and 40,960 components a
   frame at 8 detections (the plane's count column 32767); each kernel's
   registers, spills and shared memory. Phases 3,
   4, 7, 8, 17, 18, 21 and 26 fail unless run-CC ran through these
   kernels (prepare, compact and finish once a call, the propagation
   twice), phases 7 and 8 unless the finish wrote every device-rect
   batch's row tables, phase 17 if it wrote any;
34. mean-threshold mode (``adaptive double threshold = -1``): its two
   kernels (``csrc/adaptive_mean.cu``: ``ysmr_mean_prepare``, the blurred
   frames, the meanStdDev sums and the gray; ``ysmr_mean_masks``, the
   global threshold and ``& frame_valid``) against their plain versions on
   the card, bit for bit, one launch a call: the bench and dense frames
   batches (timed with the bound, with and without the gray), a 16-frame
   640x480 batch, a short padded batch, the bench batch with padding
   frames between valid ones, white and dark, the shapes of
   ``mean_mode_cases.py`` (one row, one column, one pixel, W % 4 != 0,
   frames under 16 pixels, planes 8 and 1 mod 16, a height one row past a
   band, the bench width, rows over 274 strips, a 1 x 40,000 frame of 255s
   whose row sums wrap); each kernel's registers, shared memory and
   occupancy. Then frames
   mode in mean mode on the bench scene in memory (track count, frames/s):
   ``_list.csv`` byte-identical to the pixels-mode device path's without
   cv2 centres, one prepare and one masks launch a detect batch, every
   other kernel of the frames path launched but the reconstruction and the
   adaptive preprocess, and no torch gray, blur, sums or threshold pass on
   the card (their ``cuda_calls``); the default pixels path (host
   threshold, run-CC, host rects, float64 tracker) on 16 frames, ``cuda``
   byte-identical to ``cpu``; frames mode with luminosity on 16 frames,
   ``cuda`` against ``cpu`` by ``compare_rows``;
35. the decode layer: phase 5's MJPG bench clip through
   ``track_bacteria(path)`` on ``cuda`` with exact decode and ``host
   decode threads`` 2 (striped), 1 and 0 (inline), and with ``decode mode
   = fast`` and 2 threads, in turns (the four, then in reverse): for each
   run the decoder that served (the exact fused decode, the demuxer, the
   stripes, the first-party decoder's and the gray LUT's frames, whether
   the native library has the libjpeg stage-1 decode), rows, tracks,
   frames/s end to end and ``wait_batch`` ms/frame, beside the card's name
   and power limit. Every exact run row-identical to
   ``bench_data/bench_clip_list.csv.gz`` and byte-identical to the other
   exact runs, the striped run on min(2, batches) stripes, the fast run on
   the demuxer within 4 tracks and 1% of rows of the exact runs, run-CC
   and its readback plane once a batch in every run;
36. the luminosity paths' two kernels against their plain versions on the
   card, bit-equal: the rect mean (``csrc/luminosity.cu``) on the bench
   batch's host rects (uint8 gray), the dense and frames-mode batches'
   device rects (uint8 and int32 gray) and the edge cases of the root
   module ``lum_cases.py`` (windows of 16 to 64, clipped windows, zero
   sides, exact angles, int32 gray, a frame smaller than the window); the
   pixel finish (``csrc/pixel_finish.cu``) on the bench luminosity wire's
   labels (the host-rect plane) and the dense one's (the row tables), on
   the edge cases in every combination of outputs and on one frame's list
   of 25,165,825 slots with its labels made directly (past the 25,165,824
   the finish took before its tile offsets left shared memory); ms, plain
   ms and bound of each, and the registers, spills, shared memory and
   occupancy of each of the two kernels' launches (``rect_mean_tiles``;
   ``finish_roots``, ``finish_offsets``, ``finish_ids``: a ``lum kernels
   resources`` line);
37. ``use table cc``: the table CC kernel (``csrc/table_cc.cu``,
   ``cc.cc_labels_table``) against its plain version
   (``cc_labels_table_plain``, ``ysmr_tpu``'s table route) on the card,
   bit-equal on every frame where the plain version converged: the bench
   and dense pixel tables (64 x 8192, 64 x 131072; double and single
   threshold) on the raster-prefix route the pipeline takes and sorted
   first (the two routes bit-equal, and equal to ``ysmr_cc_pixels``), the
   bench table shuffled among as many invalid slots, and two frames of 64
   x 50,000 with random rods, wider than ``ysmr_cc_pixels`` takes (it
   refuses them); ms of the kernel (each route), the plain version and
   ``ysmr_cc_pixels`` on the same tables, and the bound. The run wire's
   expansion to the pixel table (``csrc/expand_runs.cu``,
   ``run_cc.expand_runs``) against its plain version, every slot
   bit-equal, on the bench and dense run wires (timed, with the bound), on
   the wide frames' wire and on the seeded wires of ``run_cc_cases.py`` at
   tables as wide as their pixels, wider and narrower. Both kernels also
   on the edge cases of the
   root module ``table_cc_cases.py`` at their own tiling (a run across a
   tile's and a warp's edge, a window wider than the table kernel stages in
   shared memory, a checkerboard, a prefix ending mid-tile, a full frame, a
   component of many marker runs, both thresholds, both routes; F not a
   multiple of the tile, runs across tiles, a run cut at F, no tail, a
   frame with no run, counts below 0 and above R), the tiles whose window
   is read from global memory counted (the wide frames and the
   ``wide_halo`` case), and a ``table cc resources`` line (registers,
   spills, shared memory and occupancy of each launch). Then the bench
   scene in memory with ``use table cc`` on the run wire (run-CC, which
   ignores the flag: no table launch), with ``run cc = off``, the pixel
   wire and luminosity (one table launch a batch, no ``ysmr_cc_pixels``
   launch; one expansion a batch with ``run cc = off``, none otherwise),
   byte-identical to phase 4's list and phase 14's in-memory luminosity
   list, and the dense scene with ``run cc = off`` and the flag,
   byte-identical to phase 7's in-memory list.

Any failure ends the script with a non-zero exit before the result line.
The last three lines are the ``kernels`` JSON record (twenty-two
kernels: the seven TPU kernels' ports, the adaptive mean and the fused
preprocess around it, the GSFF step, the frame step, the cv2 centres, the
edge finish, the rect select, the compaction, run-CC's steps around the
propagation, mean mode's prepare and masks, the rect mean, the pixel
finish, the table CC and the run wire's expansion, each with its bound
and the library call where one exists),
``nvidia-smi``'s card name and power limit, and the result JSON.
"""

import configparser
import functools
import inspect
import json
import logging
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pandas as pd
import torch

import compact_cases as cpc
import frame_step_cases as fsc
import mean_mode_cases as mmc
import rect_tail_cases as rtc
import run_cc_cases as rcc_cases
import table_cc_cases as tcc_cases
import tracker_step_launches as tsl

from ysmr_tpu_torch import _build, graft_entry, native
from ysmr_tpu_torch.config import default_config_dict, get_configs
from ysmr_tpu_torch.io.preproc import HostPreprocessor
from ysmr_tpu_torch.ops import assignment, cc, labeling, rect, run_cc
from ysmr_tpu_torch.ops import cv2_centers as cv2c
from ysmr_tpu_torch.ops import frame_step as fs
from ysmr_tpu_torch.ops import gsff as gsff_ops
from ysmr_tpu_torch.ops import luminosity as lum_ops
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.ops.assign import row_min_argmin
from ysmr_tpu_torch.ops.gsff import GSFFParams
from ysmr_tpu_torch.ops.hull import HULL_MAX_SHARED_ROWS, hull_edge_vectors
from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
from ysmr_tpu_torch.ops.sweep import sweep_extents
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded
from ysmr_tpu_torch.pipeline import detect
from ysmr_tpu_torch.pipeline import tracker as trk
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
from ysmr_tpu_torch.pipeline.track_bacteria import _track_loop, track_bacteria
from ysmr_tpu_torch.utils.csv_io import save_list

#: csrc/run_cc.cu's wrappers, the steps around the propagations (none in a
#: checkout from before it, which trace_kernels.py may trace)
RUN_CC = tuple(getattr(run_cc, n) for n in
               ('prepare_runs', 'compact_kept_runs', 'finish_components')
               if hasattr(run_cc, n))
RUN_CC_NAMES = tuple(k.__name__ for k in RUN_CC)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, '.smoke')
W, H, FPS = 1228, 922, 30
N_FRAMES = 630
N_BUGS = 200
SEED = 123
MAX_ITERS = 64
DENSE_FRAMES = 150
DENSE_BUGS = 3000
DENSE_SEED = SEED + 2
DENSE_TRACKS = 2899          # tracks of bench_data/dense_clip_list.csv.gz
#: positions of the device tracker, cuda against cpu: a few float32 ulps
#: of a 1228-px coordinate (tests/test_torch_tracker.py)
POS_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def bench_settings():
    """tracking.ini defaults with the bench capacities (bench.py)."""
    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in default_config_dict().items():
        parser[section] = {k: str(v) for k, v in values.items()}
    ini = os.path.join(WORK, 'tracking.ini')
    with open(ini, 'w') as f:
        parser.write(f)
    settings = get_configs(ini)
    settings.update({
        'display video analysis': False, 'user input': False,
        'select files': False, 'save video': False, 'verbose': False,
        'log to file': False, 'rename previous result .csv': False,
        'collate results csv to xlsx': False,
        'max detections per frame': 512, 'max track slots': 1024,
        'max bounding box height': 64, 'frame batch size': 64,
        'max foreground pixels per frame': 8192,
    })
    return settings


def dense_settings():
    """bench.py measure_dense_e2e's capacities: above the 1024-detection
    gate, so the device measures and tracks."""
    settings = bench_settings()
    settings.update({
        'minimal frame count': 32, 'max detections per frame': 4096,
        'max track slots': 4096, 'max bounding box height': 48,
        'max foreground pixels per frame': 131072, 'frame batch size': 64,
    })
    return settings


class BenchScene:
    """The bench clip's scene (bench.py make_clip): seeded rods drifting
    over four noise planes, drawn per frame as grayscale."""

    def __init__(self, seed=SEED, n_bugs=N_BUGS):
        rng = np.random.default_rng(seed)
        self.pos = rng.uniform(30, [W - 30, H - 30], (n_bugs, 2))
        self.vel = rng.uniform(-2.0, 2.0, (n_bugs, 2))
        self.vel[:n_bugs // 3] = 0.0
        self.ang = rng.uniform(0, 180, n_bugs)
        self.noise = rng.normal(40, 4, (4, H, W)).clip(0, 255).astype(
            np.uint8)

    def frame(self, t):
        frame = self.noise[t % 4].copy()
        for i in range(len(self.pos)):
            p = self.pos[i] + self.vel[i] * t
            cv2.ellipse(frame, (int(round(p[0] % W)), int(round(p[1] % H))),
                        (4, 2), float(self.ang[i] + 2 * t * (i % 3)), 0, 360,
                        200, -1)
        return frame


class MemoryReader:
    """Batches of host-thresholded frames from memory, with the attributes
    and the background prefetch of io.video.BatchedVideoReader; with no
    ``preprocess``, batches of BGR frames (frames mode; gray to BGR is
    exact, the gray of (g, g, g) is g)."""

    def __init__(self, frames, preprocess, batch_size, prefetch=3):
        self.frames = frames
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.height, self.width = frames[0].shape
        self.fps = float(FPS)
        self.frame_count = len(frames)
        #: the prefetch thread's wall and CPU seconds spent making batches
        #: (not waiting for room in the queue)
        self.produce_s = self.produce_cpu_s = 0.0

    def _batches(self):
        bs = self.batch_size
        for s in range(0, len(self.frames), bs):
            if self.preprocess is None:
                chunk = self.frames[s:s + bs]
                batch = np.zeros((bs, self.height, self.width, 3), np.uint8)
                for i, f in enumerate(chunk):
                    batch[i] = cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
                yield {'frames': batch, 'start': s, 'count': len(chunk)}
                continue
            tabs = [self.preprocess(f) for f in self.frames[s:s + bs]]
            # every field stacked, short batches zero-padded, as
            # io.video.BatchedVideoReader does (the packed wire, or with
            # luminosity the split wire and the gray frames)
            batch = {'count': np.zeros(bs, np.int32)}
            batch['count'][:len(tabs)] = [tab['count'] for tab in tabs]
            for key in tabs[0]:
                if key != 'count':
                    first = np.asarray(tabs[0][key])
                    batch[key] = np.zeros((bs,) + first.shape, first.dtype)
                    for i, tab in enumerate(tabs):
                        batch[key][i] = tab[key]
            yield {'frames': batch, 'start': s, 'count': len(tabs)}

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)

        def work():
            batches = self._batches()
            while True:
                t0, c0 = time.perf_counter(), time.thread_time()
                b = next(batches, None)
                self.produce_s += time.perf_counter() - t0
                self.produce_cpu_s += time.thread_time() - c0
                q.put(b)
                if b is None:
                    break

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        while True:
            b = q.get()
            if b is None:
                break
            yield b
        thread.join()


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn()`` on the card (CUDA events), after two
    warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_inputs(runs, counts, w, connectivity, device):
    """(init, win, link) of one propagation at the shapes run_cc gives the
    kernel: 4-connected with the +R weak init, or 8-connected from iota."""
    wire = (torch.from_numpy(runs.view(np.int32)).to(device),
            torch.from_numpy(counts).to(device))
    dil = 1 if connectivity == 8 else 0
    if RUN_CC:
        g = run_cc.prepare_runs(*wire, w=w, dilates=(dil,),
                                weak_init=connectivity == 4)
        return g['init'], g['wins'][0], g['link']
    geo = run_cc._prepare(*wire, w=w)
    win = run_cc.run_windows(geo, dilate=dil)
    link = run_cc.chain_mask(geo, win)
    t, r = runs.shape
    iota = torch.arange(r, dtype=torch.int32, device=device).expand(t, r)
    init = torch.where(geo['rmark'], iota, iota + r) if connectivity == 4 \
        else iota
    return init.contiguous(), win, link


def contract_init(comp, rng):
    """A random init inside the kernel's contract: every run names, mod R,
    a random run of its own component (``comp``: (T, R) component ids),
    with a random weak bit (+ R)."""
    t, r = comp.shape
    order = np.lexsort((rng.random((t, r)), comp))
    c = np.take_along_axis(comp, order, 1)
    pos = np.broadcast_to(np.arange(r), (t, r))
    start = np.maximum.accumulate(
        np.where(c != np.roll(c, 1, 1), pos, 0), axis=1)
    start[:, 0] = 0
    same_next = (c == np.roll(c, -1, 1)) & (pos < r - 1)
    # the next run of the component in the shuffled order, cyclically
    target = np.where(same_next, np.roll(order, -1, 1),
                      np.take_along_axis(order, start, 1))
    init = np.empty((t, r), np.int32)
    np.put_along_axis(init, order, target.astype(np.int32), 1)
    return init + r * (rng.random((t, r)) < 0.5).astype(np.int32)


def compare_kernel(name, runs, counts, w, connectivity, dev):
    init, win, link = graph_inputs(runs, counts, w, connectivity, dev)
    lab, steps = propagate_min_fused(init, win, link, max_iters=MAX_ITERS)
    ref, ref_steps = run_cc.propagate_min(init, win, link,
                                          max_iters=MAX_ITERS)
    torch.cuda.synchronize()
    err = int((lab - ref).abs().max())
    k_steps, p_steps = int(steps.max()), int(ref_steps.max())
    if err or k_steps >= MAX_ITERS or p_steps >= MAX_ITERS:
        raise SystemExit('{}: kernel != plain (max |diff| {}) or not '
                         'converged (steps {} / {})'.format(
                             name, err, k_steps, p_steps))
    # a random init of the contract: the component-wise minimum on every
    # frame, and the plain version wherever that converged
    r = runs.shape[1]
    comp = ref % r
    rinit = torch.from_numpy(contract_init(
        comp.cpu().numpy(), np.random.default_rng(SEED + r))).to(dev)
    rlab = propagate_min_fused(rinit, win, link, max_iters=MAX_ITERS)[0]
    want = torch.full_like(rinit, 2 * r).scatter_reduce(
        1, comp.long(), rinit, 'amin')
    rref, rsteps = run_cc.propagate_min(rinit, win, link,
                                        max_iters=MAX_ITERS)
    conv = rsteps < MAX_ITERS
    if not torch.equal(rlab, torch.gather(want, 1, comp.long())) or \
            not torch.equal(rlab[conv], rref[conv]):
        raise SystemExit('{}: kernel != plain on a random init'.format(name))
    ms = cuda_ms(lambda: propagate_min_fused(init, win, link,
                                             max_iters=MAX_ITERS))
    plain_ms = cuda_ms(lambda: run_cc.propagate_min(init, win, link,
                                                    max_iters=MAX_ITERS),
                       reps=5)
    # the plain version's work, whatever implements it: per sweep and run
    # two chain neighbours, four window endpoints, a path-halving hop and
    # the compare
    ops = int((ref_steps.cpu().to(torch.int64) *
               torch.from_numpy(counts).to(torch.int64)).sum()) * 8
    bnd = bound([init, link] + [win[k] for k in ('lo_up', 'hi_up', 'lo_dn',
                                                  'hi_dn', 'ok_up', 'ok_dn')],
                [lab, steps], ops)
    log('kernel check {}: T={} R={} runs<= {} equal (and on a random init '
        'of the contract, plain converged on {} of {} frames), steps kernel '
        '{} plain {}, ms kernel {:.4f} plain {:.4f} bound {:.4f} ({})'.format(
            name, runs.shape[0], runs.shape[1], int(counts.max()),
            int(conv.sum()), runs.shape[0], k_steps, p_steps, ms, plain_ms,
            *bnd))
    return err, ms, plain_ms, bnd


def encode(packed, counts, w, r):
    runs = np.zeros(packed.shape, np.uint32)
    rc = np.zeros(len(counts), np.int32)
    ret = native.encode_runs_batch(packed, counts, runs, rc, w=w)
    if ret is None or ret < 0:
        raise SystemExit('run encoding failed: {}'.format(ret))
    bucket = r or min(packed.shape[1], 1 << max(int(ret) - 1, 1).bit_length())
    return runs[:, :bucket].copy(), rc


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this smoke test runs on a GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    log('device {} x{}'.format(torch.cuda.get_device_name(0),
                               torch.cuda.device_count()))
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit('native host library unavailable')
    log('native library {} ({:.1f} s)'.format(
        native._LIB._name, time.perf_counter() - t0))
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.load_kernels()
    log('kernel build {:.1f} s: {}'.format(time.perf_counter() - t0,
                                           os.path.relpath(lib.build_path,
                                                           REPO)))
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or \
                'Compiling entry' in line:
            log('  ptxas: ' + line.strip())


#: the seeded random run graphs of phase 3: (T, H, W, R, density)
RANDOM_GRAPHS = ((64, 922, 1228, 8192, 0.004), (8, 700, 700, 131072, 0.3),
                 (16, 64, 64, 512, 0.5))


def random_runs(rng, t, h, w, r, dens):
    """The run wire of ``t`` seeded random frames: pixels set with
    probability ``dens``, a third of them markers, cut at ``r`` pixels."""
    packed = np.zeros((t, r), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        yy, xx = np.nonzero(rng.random((h, w)) < dens)
        lin = (yy * w + xx).astype(np.uint32)[:r]
        mk = (rng.random(len(lin)) < 0.3).astype(np.uint32)
        packed[i, :len(lin)] = lin | (mk << 31)
        counts[i] = len(lin)
    return encode(packed, counts, w, r)


def phase_kernel(scene, settings, dscene, dsettings, dev):
    runs, rc = first_batch_runs(scene, settings)
    results = [compare_kernel('bench 4-conn', runs, rc, W, 4, dev),
               compare_kernel('bench 8-conn', runs, rc, W, 8, dev)]
    # the dense path's batch: the run wire's R bucket of the dense scene's
    # first 64 frames, both propagations of a double-threshold batch
    druns, drc = first_batch_runs(dscene, dsettings)
    for conn in (4, 8):
        results.append(compare_kernel('dense batch {}-conn'.format(conn),
                                      druns, drc, W, conn, dev))
    rng = np.random.default_rng(SEED)
    for t, h, w, r, dens in RANDOM_GRAPHS:
        runs, rc = random_runs(rng, t, h, w, r, dens)
        for conn in (4, 8):
            results.append(compare_kernel(
                'random {}x{} {}-conn'.format(h, w, conn), runs, rc, w, conn,
                dev))
    if propagate_min_fused.launches <= 0 or \
            run_cc.prepare_runs.launches <= 0:
        raise SystemExit('the propagation or prepare kernel was never '
                         'launched')
    return (max(r[0] for r in results),) + results[0][1:]


def run_cc_launches():
    """The run-CC kernels' counts: the propagation's and those of
    ``csrc/run_cc.cu``'s wrappers."""
    return {k.__name__: k.launches for k in (propagate_min_fused,) + RUN_CC}


def reset_run_cc():
    for k in (propagate_min_fused,) + RUN_CC:
        k.launches = 0
    run_cc.finish_components.row_table_launches = 0
    run_cc.finish_components.readback_launches = 0


def readback_gate(what, launches):
    """Raise unless run-CC's finish wrote the host-rect readback plane in
    each of its calls since ``reset_run_cc`` (the host-rect path: one a
    detect batch)."""
    calls = launches['finish_components']
    got = run_cc.finish_components.readback_launches
    if calls <= 0 or got != calls:
        raise SystemExit('{}: run-CC wrote the readback plane {} times in {} '
                         'finish calls'.format(what, got, calls))


def row_tables_gate(what, launches, detects):
    """Raise unless run-CC's finish wrote the row tables of ``detects``
    device-rect detect batches (its ``row_table_launches``), as often as
    the hull ran on them."""
    got = run_cc.finish_components.row_table_launches
    if got != detects or launches.get('hull_edge_vectors', 0) != detects:
        raise SystemExit('{}: run-CC wrote the row tables {} times and the '
                         'hull ran {} times, not once for each of {} device '
                         'rect batches'.format(
                             what, got, launches.get('hull_edge_vectors'),
                             detects))


def run_cc_gate(what, launches, double=True):
    """Raise unless run-CC ran through its kernels: prepare and finish as
    often as each other, the compaction as often with the double threshold
    (never without), the propagation twice (once) a call."""
    calls = launches['finish_components']
    want = {'prepare_runs': calls, 'compact_kept_runs': calls if double
            else 0, 'finish_components': calls,
            'propagate_min_fused': calls * (2 if double else 1)}
    if calls <= 0 or any(launches[k] != v for k, v in want.items()):
        raise SystemExit('{}: run-CC launches {}, not {} for {} calls'
                         .format(what, launches, want, calls))


def run_loop(scene_frames, settings, device, name):
    pre = None if settings.get('transfer mode') == 'frames' else \
        HostPreprocessor(settings, FPS,
                         max_fg=settings['max foreground pixels per frame'])
    reader = MemoryReader(scene_frames, pre, settings['frame batch size'])
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    _, list_name = save_list(
        path=os.path.join(folder, 'bench.avi'), result_folder=folder,
        first_call=True, rename_old_list=False,
        illumination=settings['include luminosity in tracking calculation'])
    stats = {}
    res = _track_loop(reader, settings, float(FPS), list_name,
                      device=torch.device(device), stats=stats)
    if res is None:
        raise SystemExit('stage-1 loop on {} returned None'.format(device))
    stats['reader_s'] = {'produce': reader.produce_s,
                         'produce_cpu': reader.produce_cpu_s}
    with open(list_name, 'rb') as f:
        return res, f.read(), stats


def phase_main_path(scene, settings):
    t0 = time.perf_counter()
    frames = [scene.frame(t) for t in range(N_FRAMES)]
    log('scene: {} frames of {}x{} drawn in {:.1f} s'.format(
        N_FRAMES, W, H, time.perf_counter() - t0))
    reset_run_cc()
    res, cuda_bytes, stats = run_loop(frames, settings, 'cuda', 'cuda')
    launches = run_cc_launches()
    torch.cuda.synchronize()
    cpu_res, cpu_bytes, cpu_stats = run_loop(frames, settings, 'cpu', 'cpu')
    rows = cuda_bytes.count(b'\n') - 1
    if cuda_bytes != cpu_bytes:
        raise SystemExit('_list.csv differs between cuda and cpu runs')
    run_cc_gate('main path', launches)
    readback_gate('main path', launches)
    if stats['capped_frames'] or cpu_stats['capped_frames']:
        raise SystemExit('frames reached the run-CC iteration cap')
    df = res[0]
    if df.shape[0] != rows or not np.isfinite(
            df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('unexpected rows in the returned DataFrame')
    per = {k: round(v / stats['frames'] * 1e3, 4)
           for k, v in stats['stage_s'].items()}
    log('main path: rows {} tracks {} frames {} byte-identical cuda/cpu '
        '_list.csv; kernel launches {}; frames at the iteration cap {}'
        .format(rows, stats['tracks'], stats['frames'], launches,
                stats['capped_frames']))
    log('stage-1 fps cuda {:.2f} cpu {:.2f}'.format(stats['fps'],
                                                   cpu_stats['fps']))
    log('stage split cuda (ms/frame): {}'.format(json.dumps(per)))
    log('stage split cpu (ms/frame): {}'.format(json.dumps(
        {k: round(v / cpu_stats['frames'] * 1e3, 4)
         for k, v in cpu_stats['stage_s'].items()})))
    return launches, frames, cuda_bytes


def make_clip(path, n_frames, scene=None, size=(W, H)):
    """bench.py make_clip: a scene written as an MJPG AVI (``size``
    smaller than the scene's: its top-left corner)."""
    scene = scene or BenchScene()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), FPS,
                             size)
    if not writer.isOpened():
        raise SystemExit('cannot open an MJPG writer')
    for t in range(n_frames):
        frame = scene.frame(t)[:size[1], :size[0]]
        writer.write(cv2.cvtColor(np.ascontiguousarray(frame),
                                  cv2.COLOR_GRAY2BGR))
    writer.release()
    return path


def hold_to_reference(what, ours, ref_name):
    """Rows against a committed reference list of bench_data/, as
    bench.py's check_row_parity holds them: the same row count, TRACK_ID
    and POSITION_T equal, the measured columns within 1e-9."""
    ref = pd.read_csv(os.path.join(REPO, 'bench_data', ref_name))
    ref = ref.sort_values(['TRACK_ID', 'POSITION_T'], kind='stable')
    if ours.shape[0] != ref.shape[0]:
        raise SystemExit('{}: {} rows, reference {}'.format(
            what, ours.shape[0], ref.shape[0]))
    for col, atol in (('TRACK_ID', 0), ('POSITION_T', 0),
                      ('POSITION_X', 1e-9), ('POSITION_Y', 1e-9),
                      ('WIDTH', 1e-9), ('HEIGHT', 1e-9),
                      ('DEGREES_ANGLE', 1e-9)):
        diff = np.abs(ours[col].to_numpy(float) - ref[col].to_numpy(float))
        if not (diff <= atol).all():
            raise SystemExit('{}: column {} differs from the reference list '
                             '(max {}, {} rows)'.format(
                                 what, col, float(diff.max()),
                                 int((diff > atol).sum())))


def phase_clip(settings):
    """track_bacteria(path) on the bench clip, rows held against the
    committed reference list as bench.py's check_row_parity does."""
    t0 = time.perf_counter()
    clip = make_clip(os.path.join(WORK, 'bench_clip.avi'), N_FRAMES)
    log('bench clip written in {:.1f} s'.format(time.perf_counter() - t0))
    folder = os.path.join(WORK, 'clip')
    os.makedirs(folder, exist_ok=True)
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    elapsed = time.perf_counter() - t0
    if res is None:
        raise SystemExit('track_bacteria(path) returned None')
    ours = res[0]
    hold_to_reference('bench clip', ours, 'bench_clip_list.csv.gz')
    log('bench clip via track_bacteria(path): {} rows, {} tracks, identical '
        'to bench_data/bench_clip_list.csv.gz; {:.2f} fps end to end '
        '(decode included)'.format(ours.shape[0],
                                   ours['TRACK_ID'].nunique(),
                                   N_FRAMES / elapsed))


#: NVIDIA's data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s and
#: float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def bound(inputs, outputs, ops, nbytes=None):
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once, unless
    ``nbytes`` counts only what the call's data needs) over the memory
    rate and its operations over the float32 rate. Returns (ms, 'bytes' or
    'operations')."""
    if nbytes is None:
        nbytes = sum(int(t.numel()) * t.element_size()
                     for t in list(inputs) + list(outputs))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, float(ops) / PEAK_OPS * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def kernel_record(name, source, replaces, launches, check, library_ms=None):
    """One entry of the ``kernels`` line; ``check`` is (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by)) from the kernel's phase."""
    err, ms, plain_ms, (bound_ms, bound_by) = check[:4]
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


def max_abs_err(got, want):
    """Largest |kernel - plain| over a kernel's outputs (bools as 0/1)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit('kernel output shape or type differs')
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def check_equal(name, kernel, plain, args, ops, reps=10, plain_reps=5,
                nbytes=None, view=None):
    """Kernel against its plain version on the same card tensors: every
    output bit-equal; median ms of each and the bound of the call
    (``ops``: its operation count; ``nbytes``: its bytes, where not every
    element of every input and output; ``view``: the part of the outputs
    that is compared, where not all of it)."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if view is not None:
        got, want = view(got), view(want)
        if any(g.shape != w.shape for g, w in zip(got, want)):
            raise SystemExit('{}: kernel != plain (the compared parts '
                             'differ in shape)'.format(name))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit('{}: kernel != plain (max |diff| {})'.format(
            name, max_abs_err(got, want)))
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: kernel(*args), reps=reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps=plain_reps)
    bnd = bound(args, got, ops, nbytes)
    log('kernel check {}: bit-equal, ms kernel {:.4f} plain {:.4f} bound '
        '{:.4f} ({})'.format(name, ms, plain_ms, *bnd))
    return err, ms, plain_ms, bnd


def first_batch_runs(scene, settings):
    """A scene's first 64 frames: host threshold and run wire, cut to the
    wire's R bucket."""
    return encode(*packed_batch(scene, settings), W, None)


def dense_tables(runs, rc, settings, dev):
    """Hull and sweep inputs at the shapes the dense path gives them:
    (T * max_det, max_bh) row tables and min_y, and the stats tail's
    corners and (T * max_det, K - 1) edge candidates."""
    max_det = settings['max detections per frame']
    max_bh = settings['max bounding box height']
    cc = run_cc.run_cc_components(
        torch.from_numpy(runs.view(np.int32)).to(dev),
        torch.from_numpy(rc).to(dev), w=W, double_threshold=True,
        row_tables=dict(h=H, max_det=max_det, max_bh=max_bh))
    n = cc['n_components']
    hull_args, sweep_args = rect_inputs(
        tuple(cc[k] for k in run_cc.TABLE_KEYS))
    log_tables('dense batch: T={}'.format(runs.shape[0]),
               int(n.clamp(max=max_det).sum()), sweep_args)
    return hull_args, sweep_args


def rect_inputs(rows):
    """Hull and sweep inputs as the stats tail gives them, from the row
    tables ``rows`` (row_min_x, row_max_x, row_valid, min_y): the sweep
    reads the tables, the hull's strict corners and the edge candidates
    (``labeling.SWEEP_KEYS``)."""
    tabs = labeling._stats_tail_from_tables(*rows)
    return rows, tuple(tabs[k] for k in labeling.SWEEP_KEYS)


def log_tables(what, components, sweep_args):
    """A batch's shapes and the share of its valid row extremes that are
    strict corners, the points the sweep folds."""
    row_valid, corners = sweep_args[2], sweep_args[4:6]
    n_corners = int(corners[0].sum() + corners[1].sum())
    log('{}: components {} of {} slots, rows/component {}, directions {}, '
        'valid row extremes {}, strict corners {} ({:.4f})'.format(
            what, components, row_valid.shape[0], row_valid.shape[1],
            sweep_args[6].shape[1] + 1, 2 * int(row_valid.sum()), n_corners,
            n_corners / max(2 * int(row_valid.sum()), 1)))


def frames_tables(scene, settings, dev):
    """Hull and sweep inputs at the shapes frames mode gives them: the
    scene's first 64 frames through the device preprocess, the
    reconstruction, the 8-connected labeling, the compaction, and the row
    tables of ``component_tables`` and the stats tail over them, (T *
    max_det, max_bh)."""
    max_det = settings['max detections per frame']
    max_bh = settings['max bounding box height']
    mask, marker = bench_masks(scene, settings, dev)
    mask = cc.binary_reconstruct(mask, marker & mask)
    comp, n = labeling.compact_labels(
        cc.label_components_whole_frame(mask, 8), mask, max_det=max_det)
    hull_args, sweep_args = rect_inputs(labeling.component_row_tables(
        comp, mask, max_det=max_det, max_bh=max_bh))
    log_tables('frames-mode bench batch: T={}'.format(mask.shape[0]),
               int(n.clamp(max=max_det).sum()), sweep_args)
    return hull_args, sweep_args


def random_row_tables(rng, d, r, dev, holes=False):
    """Seeded random row-extreme tables and min_y with empty components
    (min_y 2^30), short components and padding rows; with ``holes`` the
    valid rows are no prefix."""
    n_rows = rng.integers(1, r + 1, size=d)
    valid = np.arange(r)[None, :] < n_rows[:, None]
    if holes:
        valid &= rng.random((d, r)) < 0.6
    empty = rng.random(d) < 0.15
    valid[empty] = False
    min_y = np.where(empty, 1 << 30, rng.integers(0, 900, size=d))
    cx = rng.integers(0, 1200, size=(d, 1))
    half = rng.integers(0, 30, size=(d, r))
    jitter = rng.integers(-5, 6, size=(d, r))
    lo = (cx + jitter - half).astype(np.int32)
    hi = np.maximum(lo, (cx + jitter + half).astype(np.int32))
    big = 1 << 30
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.where(valid, lo, big).astype(np.int32),
        np.where(valid, hi, -big).astype(np.int32), valid,
        min_y.astype(np.int32)))


def assign_inputs(rng, r, c, k, dev):
    """Tracker rows and detections with invalid rows and columns, exact
    distance ties and exact zeros."""
    obj = rng.uniform(0, 1228, (r, k)).astype(np.float32)
    det = rng.uniform(0, 1228, (c, k)).astype(np.float32)
    ov = rng.random(r) < 0.6
    dv = rng.random(c) < 0.6
    det[1::7] = det[0::7][:len(det[1::7])]       # duplicated detections
    dv[:8] = True
    obj[::5] = det[rng.integers(0, c, len(obj[::5]))]
    return tuple(torch.from_numpy(a).to(dev) for a in (obj, ov, det, dv))


def assign_edge_inputs(rng, case, k, dev):
    """Inputs that break the assign kernel's 16-row tiles and 64 column
    slices: R and C no multiple of them (4097 x 4095), R = C = 1, C below
    one slice set (700 x 63), exact ties between columns of different
    slices (columns 3 and 4000, 10 and 75), all rows or all columns
    invalid."""
    r, c = {'4097x4095': (4097, 4095), '1x1': (1, 1),
            '700x63': (700, 63)}.get(case, (4096, 4096))
    obj, ov, det, dv = (a.cpu().numpy() for a in assign_inputs(rng, r, c, k,
                                                              'cpu'))
    if case == 'ties':
        for row, (a, b) in enumerate(((3, 4000), (10, 75))):
            det[b] = det[a]
            dv[a] = dv[b] = True
            obj[row] = det[a] + np.float32(0.25)
            ov[row] = True
    elif case == 'rows invalid':
        ov[:] = False
    elif case == 'columns invalid':
        dv[:] = False
    return tuple(torch.from_numpy(a).to(dev) for a in (obj, ov, det, dv))


def hull_ops(row_valid):
    """Slope operations of the hull call on this data: per component with
    n valid rows, n (n - 1) ordered pairs, and per pair and chain two
    subtractions, a division and a compare."""
    n = row_valid.sum(dim=1, dtype=torch.int64)
    return int((n * (n - 1)).sum()) * 2 * 4


def hull_bytes(row_valid):
    """Bytes the hull call must move on this data: row_valid and the 20
    output bytes (four float32, four flags) of every (component, row), the
    two int32 x tables only at the valid rows (the outputs elsewhere are
    zeros whatever the tables hold), min_y and count of every
    component."""
    return row_valid.numel() * (1 + 20) + int(row_valid.sum()) * 8 + \
        row_valid.shape[0] * 8


def check_hull(name, args, reps=10):
    """``check_equal`` of the hull kernel, with its bound from
    ``hull_ops`` and ``hull_bytes``."""
    return check_equal(name, hull_edge_vectors, labeling.hull_tables_plain,
                       args, hull_ops(args[2]), reps=reps,
                       nbytes=hull_bytes(args[2]))


def sweep_cost(args):
    """Operations and bytes of the sweep call on this data. Operations:
    per corner point and direction (K, the implicit (1, 0) included) four
    products, two sums, four min/max. Bytes: row_valid of every
    (component, row) and the 4 K float32 extents of every component; the
    two corner flags of a valid row, the x of a corner; min_y and the K -
    1 directions (dx, dy) of a component with a valid row."""
    row_valid, corner_l, corner_r = args[2], args[4], args[5]
    d, r = row_valid.shape
    k = args[6].shape[1] + 1
    corners = int(corner_l.sum() + corner_r.sum())
    occupied = int(row_valid.any(dim=1).sum())
    ops = corners * k * 10
    nbytes = d * r + d * k * 16 + int(row_valid.sum()) * 2 + corners * 4 + \
        occupied * (4 + (k - 1) * 8)
    return ops, nbytes


def check_sweep(name, args, reps=10):
    """``check_equal`` of the sweep kernel, with its bound from
    ``sweep_cost``."""
    ops, nbytes = sweep_cost(args)
    return check_equal(name, sweep_extents, labeling.sweep_tables_plain,
                       args, ops, reps=reps, nbytes=nbytes)


def random_sweep_args(rng, d, r, dev, holes=False):
    """The sweep's inputs of seeded random tables: the tables, the plain
    hull's corners and random integer directions (dx >= 1, dy >= 0, as
    the edge finish folds them), K - 1 = 2 (R - 1)."""
    rows = random_row_tables(rng, d, r, dev, holes)
    chains = labeling.hull_tables_plain(*rows)
    k = 2 * (r - 1)
    dx = torch.from_numpy(rng.integers(1, 90, (d, k)).astype(
        np.float32)).to(dev)
    dy = torch.from_numpy(rng.integers(0, 96, (d, k)).astype(
        np.float32)).to(dev)
    return rows + chains[6:8] + (dx, dy)


def assign_ops(ov, dv, k):
    """Distance operations of the assign call, counted over every valid
    pair whatever the kernel skips: K differences, K products/fmas, a sqrt
    and a compare (the kernel takes the sqrt on few pairs); per video and
    summed for a batched call."""
    pairs = ov.sum(-1, dtype=torch.int64) * dv.sum(-1, dtype=torch.int64)
    return int(pairs.sum()) * (2 * k + 2)


def cdist_min_ms(args):
    """Two PyTorch calls computing the row minimum and its column of the
    assign kernel: ``torch.cdist`` then ``.min(1)``, timed on the same
    inputs with the invalid rows and columns left out. A yardstick only
    (two calls, so not the record's library_ms)."""
    obj, ov, det, dv = args
    o, d = obj[ov].contiguous(), det[dv].contiguous()
    return cuda_ms(lambda: torch.cdist(o, d).min(1))


def phase_dense_kernels(scene, settings, dev, frames_args):
    """``frames_args``: the hull and sweep inputs of ``frames_tables``."""
    runs, rc = first_batch_runs(scene, settings)
    hull_args, sweep_args = dense_tables(runs, rc, settings, dev)
    rng = np.random.default_rng(SEED)
    out = {}
    hull = [check_hull('hull dense batch', hull_args, reps=20),
            check_hull('hull frames-mode bench batch', frames_args[0],
                       reps=20)]
    # R = 4000: shared memory above 48 KB a block; R above the shared cap:
    # the rows in global memory
    for d, r, holes in ((4096, 48, False), (16384, 96, False),
                        (4097, 33, True), (5, 4000, True),
                        (2, HULL_MAX_SHARED_ROWS + 1, True)):
        args = random_row_tables(rng, d, r, dev, holes)
        hull.append(check_hull('hull random D={} R={}{}'.format(
            d, r, ' (valid rows with holes)' if holes else ''), args))
    out['hull'] = (max(h[0] for h in hull),) + hull[0][1:]
    sweep = [check_sweep('sweep {} batch'.format(name), args, reps=20)
             for name, args in (('dense', sweep_args),
                                ('frames-mode bench', frames_args[1]))]
    # one to four directions a lane, two passes at K = 191; D no multiple
    # of a block's eight warps
    for d, r, holes in ((4096, 48, False), (4097, 96, True),
                        (1001, 17, True), (333, 65, False), (77, 1, False)):
        sweep.append(check_sweep('sweep random D={} R={} K={}{}'.format(
            d, r, 2 * r - 1, ' (valid rows with holes)' if holes else ''),
            random_sweep_args(rng, d, r, dev, holes), reps=3))
    # the corners' extents are those of every valid point
    for name, args in (('dense', sweep_args),
                       ('frames-mode bench', frames_args[1])):
        pts, valid = labeling.candidate_points(*args[:4])
        full = labeling.sweep_extents_plain(
            pts, valid, *labeling._with_axis(*args[6:]))
        if not all(torch.equal(a, b) for a, b in zip(
                full, labeling.sweep_tables_plain(*args))):
            raise SystemExit('sweep {} batch: the corners\' extents differ '
                             'from every valid point\'s'.format(name))
    log('sweep: the corners\' extents equal every valid point\'s on the '
        'dense and frames-mode batches')
    out['sweep'] = (max(x[0] for x in sweep),) + sweep[0][1:]
    assign = []
    for n in (4096, 16384):
        for k in (2, 3):
            args = assign_inputs(rng, n, n, k, dev)
            assign.append(check_equal(
                'assign {}x{} K={}'.format(n, n, k), row_min_argmin,
                assignment.row_min_argmin_plain, args,
                assign_ops(args[1], args[3], k), reps=10,
                plain_reps=3 if n > 4096 else 5))
            if n == 4096:
                log('assign {}x{} K={}: torch.cdist + .min(1) (two calls) '
                    '{:.4f} ms'.format(n, n, k, cdist_min_ms(args)))
    for case in ('4097x4095', '1x1', '700x63', 'ties', 'rows invalid',
                 'columns invalid'):
        for k in (2, 3):
            args = assign_edge_inputs(rng, case, k, dev)
            assign.append(check_equal(
                'assign edge case {} K={}'.format(case, k), row_min_argmin,
                assignment.row_min_argmin_plain, args,
                assign_ops(args[1], args[3], k), reps=3, plain_reps=1))
            if case == 'ties' and \
                    row_min_argmin(*args)[1][:2].tolist() != [3, 10]:
                raise SystemExit('assign ties: the first column did not win')
    out['assign'] = (max(a[0] for a in assign),) + assign[0][1:]
    return out


class WarningCounter(logging.Handler):
    """Counts the pipeline's log records that contain a phrase."""

    def __init__(self, phrase):
        super().__init__(logging.WARNING)
        self.phrase = phrase
        self.count = 0

    def emit(self, record):
        if self.phrase in record.getMessage():
            self.count += 1


KERNELS = (propagate_min_fused, hull_edge_vectors, sweep_extents,
           row_min_argmin, gsff_ops.register_and_step,
           fs.match_and_register, cv2c.cv2_centers_from_tables,
           rect.edge_finish, rect.rect_select) + RUN_CC


def tracker_gate(what, launches, per):
    """Raise unless each tracker kernel of ``launches`` ran ``per``
    times (the frame steps): the frame-step kernel and, with GSFF, the
    GSFF kernel, once a frame step, as the assign kernel."""
    for name in ('row_min_argmin', 'match_and_register',
                 'register_and_step'):
        if launches[name] != per:
            raise SystemExit('{}: {} {} launches, not one per frame step '
                             '({})'.format(what, launches[name], name, per))


def reset_launches():
    for k in KERNELS:
        k.launches = 0
    run_cc.finish_components.row_table_launches = 0
    labeling.candidate_points.cuda_calls = 0


def points_gate(what):
    """Raise if candidate points were built on the card since
    ``reset_launches``: the device-rect detect's stats tail and sweep read
    the row tables."""
    if labeling.candidate_points.cuda_calls:
        raise SystemExit('{}: candidate points built on the card {} '
                         'times'.format(
                             what, labeling.candidate_points.cuda_calls))


def rect_tail_gate(what, launches, cv2_launches):
    """Raise unless the sweep, edge-finish and rect-select kernels ran
    once a detect batch (as often as the hull kernel) and the cv2-centre
    kernel ``cv2_launches`` times."""
    per = launches['hull_edge_vectors']
    got = (launches['sweep_extents'], launches['edge_finish'],
           launches['rect_select'], cv2c.cv2_centers_from_tables.launches)
    if per <= 0 or got != (per, per, per, cv2_launches):
        raise SystemExit('{}: sweep, edge-finish, rect-select and cv2-centre '
                         'launches {}, not {} (one a detect batch)'.format(
                             what, got, (per, per, per, cv2_launches)))


def phase_dense_path(scene, frames, settings):
    """The dense path on cuda: in memory for the stage split, then the
    MJPG clip through track_bacteria(path) with every kernel counted."""
    _, dense_bytes, stats = run_loop(frames, settings, 'cuda', 'dense_mem')
    per = {k: round(v / stats['frames'] * 1e3, 4)
           for k, v in stats['stage_s'].items()}
    log('dense in memory (cuda): tracks {} frames {} fps {:.2f}, '
        'dropped registrations {}'.format(stats['tracks'], stats['frames'],
                                          stats['fps'],
                                          stats['dropped_registrations']))
    log('dense stage split cuda (ms/frame): {}'.format(json.dumps(per)))
    t0 = time.perf_counter()
    clip = make_clip(os.path.join(WORK, 'dense_clip.avi'), DENSE_FRAMES,
                     scene)
    log('dense clip written in {:.1f} s'.format(time.perf_counter() - t0))
    folder = os.path.join(WORK, 'dense_clip')
    os.makedirs(folder, exist_ok=True)
    dropped = WarningCounter('registrations dropped')
    logging.getLogger('ysmr').addHandler(dropped)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    logging.getLogger('ysmr').removeHandler(dropped)
    if res is None:
        raise SystemExit('dense track_bacteria(path) returned None')
    df = res[0]
    tracks = int(df['TRACK_ID'].nunique())
    ref = pd.read_csv(os.path.join(REPO, 'bench_data',
                                   'dense_clip_list.csv.gz'))
    ref = ref.sort_values(['TRACK_ID', 'POSITION_T'], kind='stable')
    # id agreement: the share of the reference's (TRACK_ID, POSITION_T)
    # rows that the port emits too, and of its tracks that the port
    # reproduces frame for frame under the same id
    keys = ['TRACK_ID', 'POSITION_T']
    both = ref[keys + ['POSITION_X', 'POSITION_Y']].merge(
        df[keys + ['POSITION_X', 'POSITION_Y']], on=keys,
        suffixes=('_ref', ''))
    row_agree = both.shape[0] / ref.shape[0]
    ref_frames = ref.groupby('TRACK_ID')['POSITION_T'].apply(tuple)
    our_frames = df.groupby('TRACK_ID')['POSITION_T'].apply(tuple)
    same_tracks = int((ref_frames == our_frames.reindex(
        ref_frames.index)).sum())
    shift = np.hypot(both['POSITION_X'] - both['POSITION_X_ref'],
                     both['POSITION_Y'] - both['POSITION_Y_ref'])
    agreement = ('{:.4f} of reference rows, {} of {} tracks identical in '
                 'frames, position |diff| on shared rows median {:.2e} max '
                 '{:.2e} px'.format(row_agree, same_tracks, len(ref_frames),
                                    float(shift.median()),
                                    float(shift.max())))
    log('dense clip via track_bacteria(path) on cuda: rows {} (reference '
        '{}), tracks {} (reference {}), id agreement {}, {:.2f} fps end to '
        'end (decode included), kernel launches {}, dropped-registration '
        'warnings {}'.format(df.shape[0], ref.shape[0], tracks,
                             ref['TRACK_ID'].nunique(), agreement,
                             DENSE_FRAMES / elapsed, json.dumps(launches),
                             dropped.count))
    if not np.isfinite(df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                           'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('dense clip: non-finite values in the rows')
    if abs(tracks - DENSE_TRACKS) > 10:
        raise SystemExit('dense clip: {} tracks, outside {} +- 10'.format(
            tracks, DENSE_TRACKS))
    if dropped.count:
        raise SystemExit('dense clip: registrations were dropped')
    if min(launches.values()) <= 0:
        raise SystemExit('dense clip: a kernel was never launched: {}'.format(
            launches))
    tracker_gate('dense clip', launches, launches['row_min_argmin'])
    rect_tail_gate('dense clip', launches, launches['hull_edge_vectors'])
    points_gate('dense clip')
    run_cc_gate('dense clip', launches)
    row_tables_gate('dense clip', launches, launches['finish_components'])
    return launches, dense_bytes


#: rows of bench_data/dense_clip_list.csv.gz
DENSE_ROWS = 378751
DENSE_EXACT = {'cv2 exact rects max detections': 4096}


def phase_dense_exact(frames, settings):
    """Dense exact mode: the dense capacities with the host-rect gate
    raised to them, so the dense clip goes through run-CC on the card, the
    host rects and the float64 tracker; its rows must be those of the
    committed reference list. The scene in memory first, for the stage
    split."""
    exact = {**settings, **DENSE_EXACT}
    _, _, stats = run_loop(frames, exact, 'cuda', 'dense_exact_mem')
    log('dense exact mode in memory (cuda): tracks {} frames {} fps {:.2f}; '
        'stage split (ms/frame): {}'.format(
            stats['tracks'], stats['frames'], stats['fps'],
            per_frame(stats)))
    folder = os.path.join(WORK, 'dense_exact_clip')
    os.makedirs(folder, exist_ok=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = track_bacteria(os.path.join(WORK, 'dense_clip.avi'),
                         settings=dict(exact), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    if res is None:
        raise SystemExit('dense exact mode: track_bacteria(path) returned '
                         'None')
    df = res[0]
    tracks = int(df['TRACK_ID'].nunique())
    if df.shape[0] != DENSE_ROWS or tracks != DENSE_TRACKS:
        raise SystemExit('dense exact mode: {} rows and {} tracks, the '
                         'reference has {} and {}'.format(
                             df.shape[0], tracks, DENSE_ROWS, DENSE_TRACKS))
    hold_to_reference('dense exact mode', df, 'dense_clip_list.csv.gz')
    run_cc_gate('dense exact mode', launches)
    row_tables_gate('dense exact mode', launches, 0)
    if any(v for k, v in launches.items()
           if k not in ('propagate_min_fused',) + RUN_CC_NAMES):
        raise SystemExit('dense exact mode: the device rects or tracker ran: '
                         '{}'.format(launches))
    log('dense exact mode, dense clip via track_bacteria(path) on cuda: {} '
        'rows, {} tracks, identical to bench_data/dense_clip_list.csv.gz; '
        '{:.2f} fps end to end (decode included), kernel launches {}'.format(
            df.shape[0], tracks, DENSE_FRAMES / elapsed,
            json.dumps(launches)))


def phase_dense_cuda_vs_cpu(frames, settings):
    """The dense scene's first batch at dense capacities through the
    stage-1 loop on cuda and on cpu."""
    first = frames[:settings['frame batch size']]
    reset_launches()
    (cres, _, cstats) = run_loop(first, settings, 'cuda', 'dense_cuda')
    launches = {k.__name__: k.launches for k in KERNELS}
    run_cc_gate('dense first batch', launches)
    row_tables_gate('dense first batch', launches, 1)
    points_gate('dense first batch')
    t0 = time.perf_counter()
    (pres, _, pstats) = run_loop(first, settings, 'cpu', 'dense_cpu')
    cpu_s = time.perf_counter() - t0
    same, worst = compare_rows('dense first batch', cres[0], pres[0])
    log('dense first batch cuda vs cpu: {} rows, {} tracks, TRACK_ID and '
        'POSITION_T identical, {} of {} rows byte-identical, max |diff| {}; '
        'cpu loop {:.1f} s, dropped registrations cuda {} cpu {}'.format(
            cres[0].shape[0], cstats['tracks'], same, cres[0].shape[0],
            json.dumps(worst), cpu_s, cstats['dropped_registrations'],
            pstats['dropped_registrations']))


FRAMES = {'transfer mode': 'frames'}
CC_KERNELS = (cc.label_components_whole_frame, cc.binary_reconstruct)
#: the fused preprocess, looked up so that trace_kernels.py --root can load
#: this module over a checkout from before it (None there)
ADAPTIVE_MASKS = getattr(pp, 'adaptive_masks_from_bgr', None)
#: the compaction kernel's wrapper, likewise (None before it)
COMPACT = getattr(labeling, 'compact_row_tables', None)
FRAMES_KERNELS = CC_KERNELS + (COMPACT,
                               hull_edge_vectors, sweep_extents,
                               row_min_argmin, ADAPTIVE_MASKS,
                               gsff_ops.register_and_step,
                               fs.match_and_register, rect.edge_finish,
                               rect.rect_select)


def bench_masks(scene, settings, dev, t=64):
    """Mask and markers of the bench scene's first ``t`` frames through
    the port's device preprocess (BGR upload, gray, blur, thresholds)."""
    cfg = detect.DetectorConfig(settings)
    blurred = blurred_batch([scene.frame(i) for i in range(t)], dev)
    return pp.detect_masks(blurred, cfg.mode, cfg.offset, cfg.double_delta,
                           cfg.white_on_dark)


def bgr_batch(frames, dev):
    """Gray frames as the BGR batch frames mode uploads."""
    bgr = np.stack([cv2.cvtColor(f, cv2.COLOR_GRAY2BGR) for f in frames])
    return torch.from_numpy(bgr).to(dev)


def blurred_batch(frames, dev):
    """The blurred frames of the port's device preprocess (BGR upload,
    gray, blur) of gray frames."""
    return detect.prepare_batch(bgr_batch(frames, dev))[1]


def snake_mask(h, w):
    """One serpentine component: rows joined at alternating ends, its
    geodesic diameter about h * w / 2 steps."""
    m = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        m[y, 1:w - 1] = True
        if y + 1 < h:
            m[y + 1, w - 2 if (y // 2) % 2 == 0 else 1] = True
    return m


def random_blob_masks(rng, t):
    """Seeded blob masks at 1228x922: rods and ellipses of many sizes,
    frame t - 2 all background, frame t - 1 the serpentine; markers on a
    random tenth of the blobs' pixels."""
    masks = np.zeros((t, H, W), np.uint8)
    for i in range(t - 2):
        for _ in range(int(rng.integers(50, 400))):
            c = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            ax = (int(rng.integers(1, 40)), int(rng.integers(1, 12)))
            cv2.ellipse(masks[i], c, ax, float(rng.uniform(0, 180)), 0, 360,
                        1, -1)
    masks = masks > 0
    masks[t - 1] = snake_mask(H, W)
    markers = masks & (rng.random(masks.shape) < 0.1)
    return masks, markers


def edge_cc_masks(rng):
    """Full-size masks at the labeling's edges: a checkerboard (one
    component 8-connected, singletons 4-connected), one-pixel diagonals in
    both directions across word boundaries, and a frame whose last row and
    the next frame's first row are full (a word straddles the frames:
    922 * 1228 is no multiple of 32); markers on a random tenth of the
    pixels."""
    yy, xx = np.mgrid[:H, :W]
    masks = np.stack([(yy + xx) % 2 == 0, (xx - yy) % 7 == 0,
                      (xx + yy) % 7 == 0, (xx - 2 * yy) % 9 == 0,
                      (xx + yy) % 5 == 0])
    masks[3, -1] = masks[4, 0] = True
    return masks, masks & (rng.random(masks.shape) < 0.1)


def scipy_min_index_labels(mask, connectivity):
    """scipy.ndimage.label as the minimum linear index of each component,
    h * w on the background."""
    from scipy import ndimage
    h, w = mask.shape
    structure = np.ones((3, 3), bool) if connectivity == 8 else None
    lab, n = ndimage.label(mask, structure=structure)
    uniq, first = np.unique(lab.reshape(-1), return_index=True)
    min_idx = np.full(n + 1, h * w, np.int32)
    min_idx[uniq] = first
    min_idx[0] = h * w
    return min_idx[lab]


def check_cc(name, mask, marker, scipy_frames=()):
    """Both cc kernels against their plain versions on the same card
    tensors: labels (4- and 8-connected) and the reconstruction bit-equal
    on every frame whose plain labeling converged; frames in
    ``scipy_frames`` also against scipy. Returns {kernel: (err, ms,
    plain_ms)} and the frames where the plain version did not converge."""
    from scipy import ndimage
    out, unconverged = {}, set()
    steps4 = None
    for conn in (4, 8):
        got = cc.label_components_whole_frame(mask, conn, MAX_ITERS)
        plain, steps = labeling.label_components(mask, conn, MAX_ITERS)
        torch.cuda.synchronize()
        conv = steps < MAX_ITERS
        unconverged |= set(torch.nonzero(~conv).flatten().tolist())
        if conn == 4:
            steps4 = steps
        if not torch.equal(got[conv], plain[conv]):
            raise SystemExit('{} {}-conn: labeling kernel != plain'.format(
                name, conn))
        for i in scipy_frames:
            if not np.array_equal(got[i].cpu().numpy(), scipy_min_index_labels(
                    mask[i].cpu().numpy(), conn)):
                raise SystemExit('{} {}-conn: frame {} != scipy'.format(
                    name, conn, i))
        ms = cuda_ms(lambda: cc.label_components_whole_frame(mask, conn,
                                                             MAX_ITERS))
        plain_ms = cuda_ms(lambda: labeling.label_components(mask, conn,
                                                             MAX_ITERS),
                           reps=3)
        # pack, merge, roots and write: a few operations per pixel
        bnd = bound([mask], [got], 4 * mask.numel())
        out['label{}'.format(conn)] = (0.0, ms, plain_ms, bnd)
        log('kernel check {} label {}-conn: T={} bit-equal on {} of {} '
            'frames (plain steps max {}), ms kernel {:.4f} plain {:.4f} '
            'bound {:.4f} ({})'.format(
                name, conn, mask.shape[0], int(conv.sum()), mask.shape[0],
                int(steps.max()), ms, plain_ms, *bnd))
    got = cc.binary_reconstruct(mask, marker, MAX_ITERS)
    plain = labeling.propagate_markers(mask, marker, MAX_ITERS)
    torch.cuda.synchronize()
    conv = steps4 < MAX_ITERS
    if not torch.equal(got[conv], plain[conv]):
        raise SystemExit('{}: reconstruction kernel != plain'.format(name))
    for i in scipy_frames:
        m, k = mask[i].cpu().numpy(), marker[i].cpu().numpy()
        if not np.array_equal(got[i].cpu().numpy(),
                              ndimage.binary_propagation(k & m, mask=m)):
            raise SystemExit('{}: reconstruction frame {} != scipy'.format(
                name, i))
    ms = cuda_ms(lambda: cc.binary_reconstruct(mask, marker, MAX_ITERS))
    plain_ms = cuda_ms(lambda: labeling.propagate_markers(
        mask, marker, MAX_ITERS), reps=3)
    bnd = bound([mask, marker], [got], 5 * mask.numel())
    out['reconstruct'] = (0.0, ms, plain_ms, bnd)
    log('kernel check {} reconstruct: bit-equal on {} of {} frames, kept {} '
        'of {} mask pixels, ms kernel {:.4f} plain {:.4f} bound {:.4f} ({})'
        .format(name, int(conv.sum()), mask.shape[0], int(got.sum()),
                int(mask.sum()), ms, plain_ms, *bnd))
    return out, unconverged


def check_cc_split(masks, markers, dev):
    """Both cc kernels with a call's frames split one a launch, on the
    masks without their middle row and column: 921 x 1227 pixels, an odd
    count, so every other launch starts its mask, labels and kept pixels
    off a 16-byte boundary of the batch (the byte-wise loads and stores);
    every frame held to scipy."""
    from scipy import ndimage

    def odd(a):
        return np.ascontiguousarray(np.delete(np.delete(
            a, a.shape[1] // 2, axis=1), a.shape[2] // 2, axis=2))

    masks, markers = odd(masks), odd(markers)
    n = masks.shape[1] * masks.shape[2]
    tm, tk = (torch.from_numpy(a).to(dev) for a in (masks, markers))
    saved = cc.LABEL_MAX_PIXELS, cc.RECONSTRUCT_MAX_PIXELS
    cc.LABEL_MAX_PIXELS = cc.RECONSTRUCT_MAX_PIXELS = n
    try:
        labels = {conn: cc.label_components_whole_frame(tm, conn).cpu()
                  .numpy() for conn in (4, 8)}
        kept = cc.binary_reconstruct(tm, tk).cpu().numpy()
    finally:
        cc.LABEL_MAX_PIXELS, cc.RECONSTRUCT_MAX_PIXELS = saved
    for i in range(len(masks)):
        for conn in (4, 8):
            if not np.array_equal(labels[conn][i], scipy_min_index_labels(
                    masks[i], conn)):
                raise SystemExit('split launches {}-conn: frame {} != '
                                 'scipy'.format(conn, i))
        if not np.array_equal(kept[i], ndimage.binary_propagation(
                markers[i] & masks[i], mask=masks[i])):
            raise SystemExit('split launches: reconstruction frame {} != '
                             'scipy'.format(i))
    log('edge masks at {}x{}, one frame a launch (odd offsets): labels '
        '(4- and 8-connected) and reconstruction equal to scipy on all {} '
        'frames'.format(masks.shape[2], masks.shape[1], len(masks)))


def phase_cc_kernels(scene, settings, dev):
    mask, marker = bench_masks(scene, settings, dev)
    log('bench batch thresholded on the card: T={} {}x{}, mask pixels {}, '
        'marker pixels {}'.format(mask.shape[0], W, H, int(mask.sum()),
                                  int(marker.sum())))
    main, unconv = check_cc('bench', mask, marker & mask)
    if unconv:
        raise SystemExit('bench batch: plain labeling did not converge on '
                         'frames {}'.format(sorted(unconv)))
    rng = np.random.default_rng(SEED)
    t = 8
    masks, markers = random_blob_masks(rng, t)
    _, unconv = check_cc('random blobs', torch.from_numpy(masks).to(dev),
                         torch.from_numpy(markers).to(dev),
                         scipy_frames=range(t))
    if len(unconv) > t // 2:
        raise SystemExit('random blobs: plain labeling did not converge on '
                         'frames {}'.format(sorted(unconv)))
    log('random blobs: every frame held to scipy; frames {} (the serpentine '
        'is frame {}, {} px in one component) did not converge in the plain '
        'version in {} steps and are held to scipy only'.format(
            sorted(unconv), t - 1, int(masks[t - 1].sum()), MAX_ITERS))
    masks, markers = edge_cc_masks(rng)
    _, unconv = check_cc('edge masks', torch.from_numpy(masks).to(dev),
                         torch.from_numpy(markers).to(dev),
                         scipy_frames=range(len(masks)))
    log('edge masks (checkerboard, diagonals, a word across two frames): '
        'every frame held to scipy; frames {} held to scipy only'.format(
            sorted(unconv)))
    check_cc_split(masks, markers, dev)
    return {'label_components_whole_frame': main['label8'],
            'binary_reconstruct': main['reconstruct']}


def reset_frames_launches():
    for k in FRAMES_KERNELS + (cv2c.cv2_centers_from_tables,
                               pp.adaptive_gaussian_mean):
        k.launches = 0
    labeling.candidate_points.cuda_calls = 0


def frames_launches(what):
    """The frames path's launches since ``reset_frames_launches``; raises
    unless every kernel of the path ran, the compaction one call a detect
    batch and the adaptive modes' preprocess one fused launch a detect
    batch (as many as the hull's), with no int32 adaptive-mean launch."""
    launches = {k.__name__: k.launches for k in FRAMES_KERNELS}
    if min(launches.values()) <= 0:
        raise SystemExit('{}: a kernel of the frames path was never '
                         'launched: {}'.format(what, launches))
    if launches['compact_row_tables'] != launches['hull_edge_vectors']:
        raise SystemExit('{}: {} compaction calls for {} detect batches'
                         .format(what, launches['compact_row_tables'],
                                 launches['hull_edge_vectors']))
    if pp.adaptive_gaussian_mean.launches or \
            launches['adaptive_masks_from_bgr'] != \
            launches['hull_edge_vectors']:
        raise SystemExit('{}: {} fused preprocess launches for {} detect '
                         'batches, {} int32 adaptive-mean launches'.format(
                             what, launches['adaptive_masks_from_bgr'],
                             launches['hull_edge_vectors'],
                             pp.adaptive_gaussian_mean.launches))
    launches['adaptive_gaussian_mean'] = pp.adaptive_gaussian_mean.launches
    points_gate(what)
    return launches


def phase_frames_path(frames, settings, dframes, dsettings):
    """Frames mode on cuda: the bench scene in memory against the
    pixels-mode device path without cv2 centers, the dense scene in memory
    (stage split), then both MJPG clips through track_bacteria(path)."""
    fsettings = {**settings, **FRAMES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, fbytes, stats = run_loop(frames, fsettings, 'cuda', 'frames_mem')
    torch.cuda.synchronize()
    log('frames mode bench scene in memory (cuda): rows {} tracks {} frames '
        '{} fps {:.2f} ({:.1f} s)'.format(
            fbytes.count(b'\n') - 1, stats['tracks'], stats['frames'],
            stats['fps'], time.perf_counter() - t0))
    log('frames stage split cuda (ms/frame): {}'.format(json.dumps(
        {k: round(v / stats['frames'] * 1e3, 4)
         for k, v in stats['stage_s'].items()})))
    pixels = {**settings, 'cv2 exact rects': False, 'cv2 exact centers': 'off'}
    _, pbytes, pstats = run_loop(frames, pixels, 'cuda', 'pixels_mem')
    if fbytes != pbytes:
        raise SystemExit('frames mode _list.csv differs from the pixels-mode '
                         'device path without cv2 centers')
    if not np.isfinite(res[0][['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('frames mode: non-finite values in the rows')
    log('frames mode _list.csv byte-identical to the pixels-mode device path '
        'without cv2 centers ({} rows; pixels fps {:.2f})'.format(
            fbytes.count(b'\n') - 1, pstats['fps']))
    _, _, stats = run_loop(dframes, {**dsettings, **FRAMES}, 'cuda',
                           'frames_dense_mem')
    log('frames mode dense scene in memory (cuda): tracks {} frames {} fps '
        '{:.2f}, dropped registrations {}; stage split (ms/frame): {}'.format(
            stats['tracks'], stats['frames'], stats['fps'],
            stats['dropped_registrations'], json.dumps(
                {k: round(v / stats['frames'] * 1e3, 4)
                 for k, v in stats['stage_s'].items()})))
    out = {}
    for name, clip, sets, n_frames in (
            ('bench', 'bench_clip.avi', fsettings, N_FRAMES),
            ('dense', 'dense_clip.avi', {**dsettings, **FRAMES},
             DENSE_FRAMES)):
        folder = os.path.join(WORK, 'frames_' + name)
        os.makedirs(folder, exist_ok=True)
        dropped = WarningCounter('registrations dropped')
        logging.getLogger('ysmr').addHandler(dropped)
        torch.cuda.synchronize()
        reset_frames_launches()
        t0 = time.perf_counter()
        res = track_bacteria(os.path.join(WORK, clip), settings=dict(sets),
                             result_folder=folder)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = frames_launches('frames {} clip'.format(name))
        rect_tail_gate('frames {} clip'.format(name), launches, 0)
        logging.getLogger('ysmr').removeHandler(dropped)
        if res is None:
            raise SystemExit('frames {} clip: track_bacteria(path) returned '
                             'None'.format(name))
        df = res[0]
        tracks = int(df['TRACK_ID'].nunique())
        log('frames mode {} clip via track_bacteria(path) on cuda: rows {}, '
            'tracks {}, {:.2f} fps end to end (decode included), kernel '
            'launches {}, dropped-registration warnings {}'.format(
                name, df.shape[0], tracks, n_frames / elapsed,
                json.dumps(launches), dropped.count))
        if not np.isfinite(df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all():
            raise SystemExit('frames {} clip: non-finite values'.format(name))
        if name == 'dense':
            if abs(tracks - DENSE_TRACKS) > 10:
                raise SystemExit('frames dense clip: {} tracks, outside {} '
                                 '+- 10'.format(tracks, DENSE_TRACKS))
            if dropped.count:
                raise SystemExit('frames dense clip: registrations were '
                                 'dropped')
        out[name] = launches
    return out


def compare_rows(what, a, b):
    """TRACK_ID and POSITION_T identical, positions within POS_TOL and the
    rect columns equal; returns (byte-identical rows, max |diff| per
    column)."""
    if a.shape != b.shape:
        raise SystemExit('{}: {} rows on cuda, {} on cpu'.format(
            what, a.shape[0], b.shape[0]))
    for col in ('TRACK_ID', 'POSITION_T'):
        if not np.array_equal(a[col].to_numpy(), b[col].to_numpy()):
            raise SystemExit('{}: {} differs between cuda and cpu'.format(
                what, col))
    same = np.ones(a.shape[0], bool)
    worst = {}
    for col, tol in (('POSITION_X', POS_TOL), ('POSITION_Y', POS_TOL),
                     ('WIDTH', 0.0), ('HEIGHT', 0.0),
                     ('DEGREES_ANGLE', 0.0)):
        x, y = a[col].to_numpy(float), b[col].to_numpy(float)
        diff = np.abs(x - y)
        worst[col] = float(diff.max()) if diff.size else 0.0
        same &= x == y
        if not (diff <= tol).all():
            raise SystemExit('{}: {} differs by {} (tolerance {})'.format(
                what, col, worst[col], tol))
    return int(same.sum()), worst


#: frames of the frames-mode cuda-vs-cpu check: on the H100 machine's CPU a
#: 64-frame batch took 73.7 s (over a minute), 16 frames take a quarter
FRAMES_CPU_FRAMES = 16


def phase_frames_cuda_vs_cpu(frames, settings):
    """Frames mode on the bench scene's first 16 frames (one batch of 16)
    on cuda and on cpu."""
    fsettings = {**settings, **FRAMES, 'frame batch size': FRAMES_CPU_FRAMES}
    first = frames[:FRAMES_CPU_FRAMES]
    cres, _, cstats = run_loop(first, fsettings, 'cuda', 'frames_cuda')
    t0 = time.perf_counter()
    pres, _, _ = run_loop(first, fsettings, 'cpu', 'frames_cpu')
    cpu_s = time.perf_counter() - t0
    same, worst = compare_rows('frames first frames', cres[0], pres[0])
    log('frames mode cuda vs cpu on the first {} frames (a 64-frame batch '
        'takes over a minute on the cpu): {} rows, {} tracks, TRACK_ID and '
        'POSITION_T identical, {} of {} rows byte-identical, max |diff| {}; '
        'cpu loop {:.1f} s'.format(
            len(first), cres[0].shape[0], cstats['tracks'], same,
            cres[0].shape[0], json.dumps(worst), cpu_s))


# ---- the pixel-table branch and luminosity ----

LUM = {'include luminosity in tracking calculation': True}


def packed_batch(scene, settings, t=64):
    """The host threshold's packed pixel wire of the scene's first ``t``
    frames (T, max_fg) and the pixel counts."""
    pre = HostPreprocessor(settings, FPS,
                           max_fg=settings['max foreground pixels per frame'])
    packed = np.zeros((t, pre.max_fg), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        tab = pre(scene.frame(i))
        packed[i], counts[i] = tab['px_packed'], tab['count']
    return packed, counts


def lists_from_packed(packed, counts, dev):
    """(T, F) pixel lists on the card from the packed wire (lin | marker
    << 31): int32 x and y, bool valid (the count prefix) and marker."""
    lin = (packed & 0x7FFFFFFF).astype(np.int64)
    valid = np.arange(packed.shape[1])[None, :] < counts[:, None]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        (lin % W).astype(np.int32), (lin // W).astype(np.int32), valid,
        ((packed >> 31) > 0) & valid))


def lists_from_masks(masks, markers, dev, f=None):
    """Raster-order pixel lists of (T, H, W) masks; F (by default the next
    power of two above the largest frame's pixel count) cuts longer
    frames."""
    t = masks.shape[0]
    f = f or 1 << max(int(masks.reshape(t, -1).sum(1).max()) - 1,
                      1).bit_length()
    arrs = [np.zeros((t, f), np.int32), np.zeros((t, f), np.int32),
            np.zeros((t, f), bool), np.zeros((t, f), bool)]
    for i in range(t):
        ys, xs = np.nonzero(masks[i])
        ys, xs = ys[:f], xs[:f]
        n = len(ys)
        arrs[0][i, :n], arrs[1][i, :n], arrs[2][i, :n] = xs, ys, True
        arrs[3][i, :n] = markers[i][ys, xs]
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


def scipy_pixel_labels(lists, double, frames):
    """The pixel kernel's contract from scipy, per frame: keep = valid and
    (double threshold) 4-connected within the valid pixels to a marker
    pixel; the label of a kept pixel the minimum linear index of its
    8-connected component among the kept pixels, -1 elsewhere."""
    from scipy import ndimage
    px_x, px_y, valid, marker = (a.cpu().numpy() for a in lists)
    for i in frames:
        v = valid[i]
        xs, ys, mk = px_x[i][v], px_y[i][v], marker[i][v]
        m = np.zeros((H, W), bool)
        m[ys, xs] = True
        seed = np.zeros((H, W), bool)
        seed[ys[mk], xs[mk]] = True
        kept = ndimage.binary_propagation(seed, mask=m) if double else m
        keep = np.zeros_like(v)
        keep[v] = kept[ys, xs]
        lab = np.full(v.shape, -1, np.int32)
        lab[v] = np.where(keep[v], scipy_min_index_labels(kept, 8)[ys, xs],
                          -1)
        yield i, lab, keep


def compose_5_6(lists, double):
    """The pixel kernel's function from the whole-frame kernels: rasterize
    the lists, reconstruction (kernel 5), 8-connected labels (kernel 6),
    gather at the pixels."""
    px_x, px_y, valid, marker = lists
    t, n = px_x.shape[0], H * W
    dev = px_x.device
    flat = px_y.long() * W + px_x.long() + \
        torch.arange(t, device=dev)[:, None] * n

    def raster(sel):
        img = torch.zeros(t * n + 1, dtype=torch.bool, device=dev)
        img[torch.where(sel, flat, torch.full_like(flat, t * n))] = True
        return img[:t * n].view(t, H, W)

    mask = raster(valid)
    if double:
        mask = cc.binary_reconstruct(mask, raster(valid & marker))
    lab8 = cc.label_components_whole_frame(mask, 8)
    keep = valid & mask.reshape(-1)[flat]
    return torch.where(keep, lab8.reshape(-1)[flat],
                       torch.full((), -1, dtype=torch.int32,
                                  device=dev)), keep


def pixel_ops(valid, w=W):
    """Operations of the pixel function (``ysmr_cc_pixels``, the table
    CC), a fixed count per valid slot and pass: finding the upper
    neighbours among the about w + 2 slots before it (log2(w + 2)
    comparisons) and a few neighbour tests. The bound is the lists' bytes
    either way."""
    return int(valid.sum()) * 2 * (int(np.log2(w + 2)) + 8)


def check_pixels(name, lists, double):
    """The pixel kernel against its plain version (bit-equal on every frame
    where the plain labelings converged), against kernels 5 + 6 and
    against scipy (every frame); median ms of each and the bound. Returns
    (err, ms, plain_ms, bound, compose_ms)."""
    kw = dict(h=H, w=W, double_threshold=double, max_iters=MAX_ITERS)
    lab, keep = cc.cc_labels_at_pixels(*lists, **kw)
    p_lab, p_keep, steps = cc.cc_labels_at_pixels_plain(*lists, **kw)
    c_lab, c_keep = compose_5_6(lists, double)
    torch.cuda.synchronize()
    conv = steps < MAX_ITERS
    if not (torch.equal(lab[conv], p_lab[conv]) and
            torch.equal(keep[conv], p_keep[conv])):
        raise SystemExit('{}: pixel kernel != plain'.format(name))
    if not (torch.equal(lab, c_lab) and torch.equal(keep, c_keep)):
        raise SystemExit('{}: pixel kernel != kernels 5 + 6'.format(name))
    lab_np, keep_np = lab.cpu().numpy(), keep.cpu().numpy()
    for i, s_lab, s_keep in scipy_pixel_labels(lists, double,
                                               range(lab.shape[0])):
        if not (np.array_equal(lab_np[i], s_lab) and
                np.array_equal(keep_np[i], s_keep)):
            raise SystemExit('{}: frame {} != scipy'.format(name, i))
    err = max_abs_err((lab[conv], keep[conv]), (p_lab[conv], p_keep[conv]))
    ms = cuda_ms(lambda: cc.cc_labels_at_pixels(*lists, **kw))
    plain_ms = cuda_ms(lambda: cc.cc_labels_at_pixels_plain(*lists, **kw),
                       reps=3)
    comp_ms = cuda_ms(lambda: compose_5_6(lists, double), reps=5)
    bnd = bound(lists, (lab, keep), pixel_ops(lists[2]))
    log('kernel check {}: T={} F={} pixels {} kept {}, equal to scipy on '
        'every frame, to kernels 5 + 6, and bit-equal to plain on {} of {} '
        'frames (plain steps max {}); ms kernel {:.4f} plain {:.4f} '
        'kernels 5+6 {:.4f} bound {:.4f} ({})'.format(
            name, lab.shape[0], lab.shape[1], int(lists[2].sum()),
            int(keep.sum()), int(conv.sum()), lab.shape[0],
            int(steps.max()), ms, plain_ms, comp_ms, *bnd))
    return err, ms, plain_ms, bnd, comp_ms


#: list slots of the edge-case batch: no multiple of the kernel's
#: 2048-slot tiles
EDGE_F = 10000


def edge_pixel_masks(rng):
    """Frames that break the pixel kernel's tiling (2048-slot tiles with
    the w + 1 slots before each as halo), one marker each where named:
    0 full rows 0-2, so row 1's run crosses the tile boundary at slot
    2048; 1 a full-width block of rows 300-307 (9824 px, five tiles) with
    one marker, beside an unmarked blob; 2 empty; 3 exactly EDGE_F pixels
    (a full list); 4 random ellipses cut at EDGE_F."""
    masks = np.zeros((5, H, W), bool)
    masks[0, :3] = True
    masks[1, 300:308] = True
    masks[1, 400:403, 100:141] = True
    masks[3, :8] = True
    masks[3, 8, :EDGE_F - 8 * W] = True
    ell = np.zeros((H, W), np.uint8)
    for _ in range(300):
        cv2.ellipse(ell, (int(rng.integers(0, W)), int(rng.integers(0, H))),
                    (int(rng.integers(1, 30)), int(rng.integers(1, 10))),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
    masks[4] = ell > 0
    markers = masks & (rng.random(masks.shape) < 0.01)
    markers[:2] = False
    markers[0, 1, 5] = markers[1, 303, 700] = True
    return masks, markers


def phase_pixel_kernel(scene, settings, dscene, dsettings, dev):
    """Phase a: the pixel kernel on the bench batch (single and double
    threshold), on the dense batch and on random blobs with the
    serpentine."""
    lists = lists_from_packed(*packed_batch(scene, settings), dev)
    main = check_pixels('pixels bench batch double', lists, True)
    check_pixels('pixels bench batch single', lists, False)
    dlists = lists_from_packed(*packed_batch(dscene, dsettings), dev)
    check_pixels('pixels dense batch double', dlists, True)
    masks, markers = random_blob_masks(np.random.default_rng(SEED + 4), 8)
    blists = lists_from_masks(masks, markers, dev)
    check_pixels('pixels random blobs double', blists, True)
    check_pixels('pixels random blobs single', blists, False)
    masks, markers = edge_pixel_masks(np.random.default_rng(SEED + 5))
    elists = lists_from_masks(masks, markers, dev, f=EDGE_F)
    counts = elists[2].sum(1).tolist()
    if not (counts[2] == 0 and counts[3] == EDGE_F and
            counts[1] > 4 * 2048 and counts[0] > 2048):
        raise SystemExit('pixel edge lists: unexpected counts {}'.format(
            counts))
    check_pixels('pixels edge lists double', elists, True)
    check_pixels('pixels edge lists single', elists, False)
    return main


def per_frame(stats):
    return json.dumps({k: round(v / stats['frames'] * 1e3, 4)
                       for k, v in stats['stage_s'].items()})


def phase_pixel_wires(frames, settings, run_bytes):
    """Phase b: the bench scene in memory with the pixel wire, then with
    'run cc = off'; each _list.csv byte-identical to the run-wire path's."""
    for key, extra in (('pixels', {'wire format': 'pixels'}),
                       ('runcc_off', {'run cc': 'off'})):
        torch.cuda.synchronize()
        cc.cc_labels_at_pixels.launches = 0
        cc.pixel_finish.launches = 0
        _, got, stats = run_loop(frames, {**settings, **extra}, 'cuda',
                                 'wire_' + key)
        torch.cuda.synchronize()
        launches = cc.cc_labels_at_pixels.launches
        if got != run_bytes:
            raise SystemExit('{}: _list.csv differs from the run-wire '
                             'path'.format(extra))
        if launches <= 0:
            raise SystemExit('{}: the pixel kernel was never launched'.format(
                extra))
        if cc.pixel_finish.launches != n_batches(len(frames), settings):
            raise SystemExit('{}: the pixel finish ran {} times, not once a '
                             'batch'.format(extra, cc.pixel_finish.launches))
        log('bench scene in memory with {} (cuda): rows {} tracks {} fps '
            '{:.2f}, byte-identical to the run-wire path; pixel kernel '
            'launches {}; stage split (ms/frame): {}'.format(
                json.dumps(extra), got.count(b'\n') - 1, stats['tracks'],
                stats['fps'], launches, per_frame(stats)))


def lum_check(what, grays, t_idx, rects, lums, n_sample, rng):
    """ILLUMINATION against cv2's recipe (boxPoints, fillPoly, mean / 100)
    on sampled rects of their own frames: within 1e-5 wherever cv2's
    integer corners equal the port's. Rects reaching past the frame are
    left out (cv2 clips the outline, the port clips by membership; a
    documented deviation), and rects whose corners differ from cv2's (a
    knife edge; OpenCV 5 computes two corners another way than OpenCV 4)
    are counted and must stay under 1%."""
    from ysmr_tpu_torch.ops.luminosity import box_points_int
    pick = np.sort(rng.choice(len(t_idx), min(n_sample, len(t_idx)),
                              replace=False))
    r32 = [np.ascontiguousarray(rects[pick, k], np.float32)
           for k in range(5)]
    ours = box_points_int(*(torch.from_numpy(a) for a in r32)).numpy()
    checked = border = corner = 0
    worst = 0.0
    for j, i in enumerate(pick):
        box = np.intp(cv2.boxPoints(((r32[0][j], r32[1][j]),
                                     (r32[2][j], r32[3][j]), r32[4][j])))
        if box.min() < 0 or (box[:, 0] >= W).any() or (box[:, 1] >= H).any():
            border += 1
            continue
        if sorted(map(tuple, box.tolist())) != \
                sorted(map(tuple, ours[j].tolist())):
            corner += 1
            continue
        mask = np.zeros((H, W), np.uint8)
        cv2.fillPoly(mask, [box], 255)
        want = cv2.mean(grays[t_idx[i]], mask)[0] / 100.0
        worst = max(worst, abs(float(lums[i]) - want))
        checked += 1
    log('{}: ILLUMINATION of {} sampled rects against cv2 {} recipe: {} '
        'checked, max |diff| {:.3e}; {} past the frame border left out; {} '
        'with other integer corners than cv2.boxPoints'.format(
            what, len(pick), cv2.__version__, checked, worst, border,
            corner))
    if worst > 1e-5 or checked < 1000 or corner > 0.01 * len(pick):
        raise SystemExit('{}: ILLUMINATION check failed'.format(what))


def rows_lum_check(what, df, grays, rng):
    """lum_check on the rows of a run with measured positions (the
    float64 tracker without GSFF); coasting rows carry no rect."""
    rows = df[(df['WIDTH'] > 0) | (df['HEIGHT'] > 0)]
    lum_check(what, grays, rows['POSITION_T'].to_numpy(),
              rows[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                    'DEGREES_ANGLE']].to_numpy(), rows['ILLUMINATION']
              .to_numpy(), 1500, rng)


def clip_grays(path):
    """The clip's frames as cv2 decodes them, to grayscale."""
    cap = cv2.VideoCapture(path)
    grays = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        grays.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    return grays


def track_clip(name, clip, settings, kernels):
    """track_bacteria(path) on cuda with the launches of ``kernels``
    counted from 0; returns (DataFrame, launches, frames/s)."""
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if res is None:
        raise SystemExit('{}: track_bacteria(path) returned None'.format(
            name))
    df = res[0]
    if 'ILLUMINATION' not in df or not np.isfinite(
            df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE', 'ILLUMINATION']].to_numpy()).all():
        raise SystemExit('{}: missing or non-finite columns'.format(name))
    if min(launches.values()) <= 0:
        raise SystemExit('{}: a kernel of the path was never launched: '
                         '{}'.format(name, launches))
    n_frames = int(df['POSITION_T'].max()) + 1
    return df, launches, n_frames / elapsed


def cuda_vs_cpu(what, frames, settings, n=16):
    """The first ``n`` frames in memory through the stage-1 loop on cuda
    and on cpu: byte-identical _list.csv."""
    sets = {**settings, 'frame batch size': n}
    _, cbytes, _ = run_loop(frames[:n], sets, 'cuda', what + '_cuda')
    t0 = time.perf_counter()
    _, pbytes, _ = run_loop(frames[:n], sets, 'cpu', what + '_cpu')
    if cbytes != pbytes:
        raise SystemExit('{}: _list.csv differs between cuda and cpu'.format(
            what))
    log('{} cuda vs cpu on the first {} frames: {} rows byte-identical; cpu '
        'loop {:.1f} s'.format(what, n, cbytes.count(b'\n') - 1,
                               time.perf_counter() - t0))


def phase_lum_bench(frames, settings):
    """Phase c: the bench MJPG clip with luminosity and GSFF (host rects
    feed the device tracker), then its first 64 frames without GSFF (the
    float64 tracker in 3-D), the ILLUMINATION checks, and cuda against
    cpu."""
    lset = {**settings, **LUM}
    df, launches, fps = track_clip(
        'lum_clip', os.path.join(WORK, 'bench_clip.avi'), lset,
        (cc.cc_labels_at_pixels, row_min_argmin, gsff_ops.register_and_step,
         fs.match_and_register, lum_ops.rect_mean_luminosity,
         cc.pixel_finish))
    lum_gate('bench clip with luminosity and GSFF', launches,
             n_batches(N_FRAMES, lset), n_batches(N_FRAMES, lset))
    log('bench clip with luminosity and GSFF via track_bacteria(path) on '
        'cuda: rows {} tracks {} {:.2f} fps end to end (decode included), '
        'kernel launches {}'.format(df.shape[0], df['TRACK_ID'].nunique(),
                                    fps, json.dumps(launches)))
    clip64 = make_clip(os.path.join(WORK, 'bench_clip64.avi'), 64)
    off, off_launches, off_fps = track_clip(
        'lum_clip64', clip64, {**lset, 'disable gsff': True,
                               'minimal frame count': 32},
        (cc.cc_labels_at_pixels, lum_ops.rect_mean_luminosity,
         cc.pixel_finish))
    lum_gate('bench clip64 without GSFF', off_launches, 1, 1)
    log('its first 64 frames without GSFF (float64 tracker, dims 3): rows '
        '{} tracks {} {:.2f} fps, kernel launches {}'.format(
            off.shape[0], off['TRACK_ID'].nunique(), off_fps,
            json.dumps(off_launches)))
    rng = np.random.default_rng(SEED)
    rows_lum_check('bench clip, GSFF off', off, clip_grays(clip64), rng)
    # with GSFF the rows carry filtered positions; their ILLUMINATION is
    # the measured rect's: the GSFF-off row of the same frame and rect
    # (W, H, angle) within 3 px is the same detection, where only one is
    keys = ['POSITION_T', 'WIDTH', 'HEIGHT', 'DEGREES_ANGLE']
    on = df[(df['POSITION_T'] < 64) & (df['WIDTH'] > 0)].reset_index()
    pairs = on.merge(off[off['WIDTH'] > 0], on=keys, suffixes=('', '_off'))
    near = np.hypot(pairs['POSITION_X'] - pairs['POSITION_X_off'],
                    pairs['POSITION_Y'] - pairs['POSITION_Y_off']) < 3.0
    pairs = pairs[near].drop_duplicates('index', keep=False)
    same = int((pairs['ILLUMINATION'] == pairs['ILLUMINATION_off']).sum())
    log('bench clip, GSFF on: ILLUMINATION equal to the GSFF-off run on {} '
        'of {} rows of the same detection'.format(same, pairs.shape[0]))
    if pairs.shape[0] < 1000 or same != pairs.shape[0]:
        raise SystemExit('bench clip: GSFF-on ILLUMINATION differs')
    _, got, stats = run_loop(frames, lset, 'cuda', 'lum_mem')
    log('bench scene with luminosity and GSFF in memory (cuda): rows {} '
        'tracks {} fps {:.2f}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['tracks'], stats['fps'],
            per_frame(stats)))
    cuda_vs_cpu('bench luminosity', frames, lset)
    return launches, got


def phase_lum_dense(dscene, dframes, dsettings, dense_bytes, dev):
    """Phase d: the dense clip with luminosity (device rects and tracker),
    the ILLUMINATION check on the first batch's detections, cuda against
    cpu, and the pixel wire without luminosity against the run wire."""
    lset = {**dsettings, **LUM}
    df, launches, fps = track_clip(
        'lum_dense_clip', os.path.join(WORK, 'dense_clip.avi'), lset,
        (cc.cc_labels_at_pixels, hull_edge_vectors, sweep_extents,
         row_min_argmin, gsff_ops.register_and_step, fs.match_and_register,
         lum_ops.rect_mean_luminosity, cc.pixel_finish))
    lum_gate('dense clip with luminosity', launches,
             n_batches(DENSE_FRAMES, lset), n_batches(DENSE_FRAMES, lset))
    log('dense clip with luminosity via track_bacteria(path) on cuda: rows '
        '{} tracks {} {:.2f} fps end to end (decode included), kernel '
        'launches {}'.format(df.shape[0], df['TRACK_ID'].nunique(), fps,
                             json.dumps(launches)))
    packed, counts = packed_batch(dscene, dsettings)
    t = len(counts)
    gray = torch.from_numpy(np.stack(dframes[:t])).to(dev)
    tables = detect_from_pixels(
        None, None, torch.from_numpy(counts).to(dev), None,
        torch.ones(t, dtype=torch.bool, device=dev),
        px_packed=torch.from_numpy(packed.view(np.int32)).to(dev), h=H, w=W,
        double_threshold=True, max_det=dsettings['max detections per frame'],
        max_bh=dsettings['max bounding box height'], cc_iters=MAX_ITERS,
        include_luminosity=True, gray_frames=gray, lum_win=48)
    v = tables['det_valid'].cpu().numpy()
    t_idx = np.nonzero(v)[0]
    xy = tables['det_xy'].cpu().numpy()[v]
    info = tables['det_info'].cpu().numpy()[v]
    lum_check('dense first batch detections (exact centers)', dframes,
              t_idx, np.concatenate([xy[:, :2], info], axis=1), xy[:, 2],
              1500, np.random.default_rng(SEED))
    _, got, stats = run_loop(dframes, lset, 'cuda', 'lum_dense_mem')
    log('dense scene with luminosity in memory (cuda): rows {} tracks {} fps '
        '{:.2f}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['tracks'], stats['fps'],
            per_frame(stats)))
    cuda_vs_cpu('dense luminosity', dframes, lset)
    torch.cuda.synchronize()
    cc.cc_labels_at_pixels.launches = 0
    cc.pixel_finish.launches = 0
    _, got, stats = run_loop(dframes, {**dsettings, 'wire format': 'pixels'},
                             'cuda', 'dense_wire_pixels')
    torch.cuda.synchronize()
    if got != dense_bytes:
        raise SystemExit('dense scene: the pixel wire _list.csv differs from '
                         'the run wire')
    if cc.pixel_finish.launches != n_batches(len(dframes), dsettings):
        raise SystemExit('dense scene, pixel wire: the pixel finish ran {} '
                         'times, not once a batch'.format(
                             cc.pixel_finish.launches))
    log('dense scene in memory with the pixel wire (cuda): rows {} fps '
        '{:.2f}, byte-identical to the run-wire path; pixel kernel launches '
        '{}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['fps'],
            cc.cc_labels_at_pixels.launches, per_frame(stats)))
    return launches


def phase_lum_frames(frames, settings):
    """Phase e: frames-mode luminosity on the bench scene in memory, and
    cuda against cpu on its first 16 frames."""
    fset = {**settings, **FRAMES, **LUM}
    torch.cuda.synchronize()
    reset_frames_launches()
    lum_ops.rect_mean_luminosity.launches = 0
    cc.pixel_finish.launches = 0
    res, got, stats = run_loop(frames, fset, 'cuda', 'lum_frames')
    torch.cuda.synchronize()
    launches = frames_launches('frames mode with luminosity')
    lum_gate('frames mode with luminosity', {
        'rect_mean_luminosity': lum_ops.rect_mean_luminosity.launches,
        'pixel_finish': cc.pixel_finish.launches},
        n_batches(len(frames), fset), 0)
    if not np.isfinite(res[0]['ILLUMINATION'].to_numpy()).all():
        raise SystemExit('frames mode with luminosity: non-finite values')
    log('frames mode with luminosity, bench scene in memory (cuda): rows {} '
        'tracks {} fps {:.2f}, kernel launches {}; stage split (ms/frame): '
        '{}'.format(got.count(b'\n') - 1, stats['tracks'], stats['fps'],
                    json.dumps(launches), per_frame(stats)))
    cuda_vs_cpu('frames luminosity', frames, fset)


# ---- the user's program: ysmr(), the CLI, the display, the readback ----

#: the program's wrapper, written into the work directory at run time: it
#: replaces ysmr_tpu_torch.plot_functions (a GPU host may have no
#: matplotlib) with a stub that records each call, before anything imports
#: the package, also in the spawn children, which import this file as
#: their main module; run as a script it times the stages, counts the
#: kernels' launches and calls cli() on its arguments
PROGRAM_MAIN = """
import json, os, sys, time, types

RECORD = os.environ['SMOKE_PROGRAM_RECORD']


def note(**entry):
    entry['pid'] = os.getpid()
    with open(RECORD, 'a') as f:
        f.write(json.dumps(entry) + '\\n')


def stub_plot(name):
    def plot(*args, **kwargs):
        note(plot=name, save_path=kwargs.get('save_path'))
    return plot


stub = types.ModuleType('ysmr_tpu_torch.plot_functions')
for name in ('angle_distribution_plot', 'large_xy_plot', 'rose_graph',
             'violin_plot'):
    setattr(stub, name, stub_plot(name))
sys.modules['ysmr_tpu_torch.plot_functions'] = stub

if __name__ == '__main__':
    import ysmr_tpu_torch.main as program
    from ysmr_tpu_torch.__main__ import cli
    from ysmr_tpu_torch.ops.assign import row_min_argmin
    from ysmr_tpu_torch.ops.cc import (binary_reconstruct,
                                       cc_labels_at_pixels,
                                       label_components_whole_frame)
    from ysmr_tpu_torch.ops.frame_step import match_and_register
    from ysmr_tpu_torch.ops.gsff import register_and_step
    from ysmr_tpu_torch.ops.hull import hull_edge_vectors
    from ysmr_tpu_torch.ops.labeling import compact_row_tables
    from ysmr_tpu_torch.ops.preprocess import (adaptive_gaussian_mean,
                                               adaptive_masks_from_bgr)
    from ysmr_tpu_torch.ops.rect import edge_finish, rect_select
    from ysmr_tpu_torch.ops.run_cc import (compact_kept_runs,
                                           finish_components, prepare_runs)
    from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
    from ysmr_tpu_torch.ops.sweep import sweep_extents

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                note(stage=name, s=time.perf_counter() - t0)
        return call

    for name in ('track_bacteria', 'track_videos_sharded', 'select_tracks',
                 'evaluate_tracks', 'annotate_video',
                 'collate_results_csv_to_xlsx'):
        setattr(program, name, timed(name, getattr(program, name)))
    kernels = (propagate_min_fused, hull_edge_vectors, sweep_extents,
               row_min_argmin, label_components_whole_frame,
               binary_reconstruct, cc_labels_at_pixels,
               adaptive_gaussian_mean, adaptive_masks_from_bgr,
               compact_row_tables, register_and_step, match_and_register,
               edge_finish, rect_select, prepare_runs, compact_kept_runs,
               finish_components)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli(sys.argv[1:])
    note(cli_s=time.perf_counter() - t0, rc=rc,
         launches={k.__name__: k.launches for k in kernels})
    sys.exit(rc)
"""

#: the analysis stages' outputs that the program writes per input
STAGE_SUFFIXES = ('_selected_data.csv', '_statistics.csv', '_analysed.csv')


def program_ini(path, overrides):
    """A tracking.ini: the defaults with ``overrides`` (settings keys)."""
    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in default_config_dict().items():
        parser[section] = {k: str(overrides.get(k, v))
                           for k, v in values.items()}
    with open(path, 'w') as f:
        parser.write(f)
    return path


#: bench_settings() as an ini for the program: plots on (the defaults),
#: the live display on (the run is headless), no prompts
PROGRAM_SETTINGS = {
    'display video analysis': True, 'user input': False,
    'select files': False, 'shut down after analysis': False,
    'save video': False, 'log to file': False,
    'rename previous result .csv': False,
    'collate results csv to xlsx': True, 'max detections per frame': 512,
    'max track slots': 1024, 'max bounding box height': 64,
    'frame batch size': 64, 'max foreground pixels per frame': 8192,
}


def run_program(name, args, ini):
    """``python -m ysmr_tpu_torch`` through the wrapper in a subprocess on
    a headless environment; returns (records, result folder, wall s)."""
    main = os.path.join(WORK, 'program_main.py')
    if not os.path.exists(main):
        with open(main, 'w') as f:
            f.write(PROGRAM_MAIN)
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    record = os.path.join(WORK, name + '.jsonl')
    env = {k: v for k, v in os.environ.items()
           if k not in ('DISPLAY', 'WAYLAND_DISPLAY')}
    env.update(SMOKE_PROGRAM_RECORD=record, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, main] + list(args) + [
            '--settings', ini, '--result-folder', folder],
        cwd=folder, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    with open(os.path.join(WORK, name + '.log'), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise SystemExit('{}: the program exited {}'.format(name,
                                                            proc.returncode))
    with open(record) as f:
        return [json.loads(line) for line in f], folder, wall


class PlotStub:
    """The program's plot stub in this process, while a block runs."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import types
        stub = types.ModuleType('ysmr_tpu_torch.plot_functions')
        for name in ('angle_distribution_plot', 'large_xy_plot',
                     'rose_graph', 'violin_plot'):
            setattr(stub, name, lambda *a, _n=name, **k: self.calls.append(
                (_n, k.get('save_path'))))
        self.saved = sys.modules.get('ysmr_tpu_torch.plot_functions')
        sys.modules['ysmr_tpu_torch.plot_functions'] = stub
        return self

    def __exit__(self, *exc):
        sys.modules['ysmr_tpu_torch.plot_functions'] = self.saved


#: columns that hold the direction of a displacement (or follow from it).
#: A stationary rod's displacement is round-off, and the CSV restart path
#: reads the positions back with pandas' default float parser, which is not
#: correctly rounded (an ulp off, and the reference list is written with
#: other last digits), so these cells may differ between the two paths;
#: they are counted, every other cell is held
DIRECTION_COLUMNS = ('Arc-Chord Ratio', 'angle_diff', 'tp_of_tracks')


def _cells_close(a, b):
    """Elementwise: equal, both NaN, or within 1e-9 (relative and absolute:
    the repo's own restart tolerance, tests/test_main_orchestration.py)."""
    return (a == b) | (np.isnan(a) & np.isnan(b)) | \
        (np.abs(a - b) <= 1e-9 + 1e-9 * np.abs(b))


def csv_cells_match(what, got_path, want_path):
    """Two stage CSVs cell for cell: the same header, rows and text cells,
    numbers within 1e-9 outside DIRECTION_COLUMNS; returns (byte-identical
    files, identical rows, rows, the largest held difference, {direction
    column: differing cells})."""
    with open(got_path, 'rb') as f, open(want_path, 'rb') as g:
        got_b, want_b = f.read(), g.read()
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    if list(got.columns) != list(want.columns) or got.shape != want.shape:
        raise SystemExit('{}: {} against {}'.format(what, got.shape,
                                                    want.shape))
    worst, loose = 0.0, {}
    for col in want.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        if a.dtype.kind in 'fiub' and b.dtype.kind in 'fiub':
            a, b = a.astype(float), b.astype(float)
            close = _cells_close(a, b)
        else:
            close = a == b
        if col in DIRECTION_COLUMNS:
            loose[col] = int((~close).sum())
            continue
        if not close.all():
            raise SystemExit('{}: column {} differs on {} rows'.format(
                what, col, int((~close).sum())))
        if a.dtype.kind == 'f':
            diff = np.abs(a - b)
            diff = diff[~np.isnan(diff)]
            worst = max(worst, float(diff.max()) if diff.size else 0.0)
    same_rows = sum(x == y for x, y in zip(got_b.splitlines(),
                                           want_b.splitlines()))
    return got_b == want_b, same_rows, got.shape[0], worst, loose


def xlsx_cells(path):
    """{sheet part: {cell: (type, text)}} of a workbook the port wrote."""
    import re
    import zipfile
    cell = re.compile(r'<c r="([A-Z]+[0-9]+)"(?: t="(\w+)")?>'
                      r'(?:<v>(.*?)</v>|<is><t>(.*?)</t></is>)</c>')
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if name.startswith('xl/worksheets/'):
                text = zf.read(name).decode()
                out[name] = {m.group(1): (m.group(2), m.group(3)
                                          if m.group(3) is not None
                                          else m.group(4))
                             for m in cell.finditer(text)}
            elif name == 'xl/workbook.xml':
                out[name] = zf.read(name)
    return out


def xlsx_match(got_path, want_path):
    """The two workbooks' sheets cell for cell (numbers within 1e-9) outside
    the DIRECTION_COLUMNS; returns (identical cells, cells, differing
    cells in the direction columns)."""
    import re
    got, want = xlsx_cells(got_path), xlsx_cells(want_path)
    if sorted(got) != sorted(want) or \
            got['xl/workbook.xml'] != want['xl/workbook.xml']:
        raise SystemExit('collated xlsx: the sheets differ')
    same = total = loose = 0
    for part in want:
        if part == 'xl/workbook.xml':
            continue
        if sorted(got[part]) != sorted(want[part]):
            raise SystemExit('collated xlsx: the cells of {} differ'.format(
                part))
        direction = {ref[:-1] for ref, (_, text) in want[part].items()
                     if re.fullmatch('[A-Z]+1', ref)
                     and text in DIRECTION_COLUMNS}
        for ref, (kind, text) in want[part].items():
            gkind, gtext = got[part][ref]
            total += 1
            if (gkind, gtext) == (kind, text):
                same += 1
            elif kind is None and gkind is None and _cells_close(
                    np.float64(gtext), np.float64(text)):
                pass
            elif re.sub('[0-9]', '', ref) in direction:
                loose += 1
            else:
                raise SystemExit('collated xlsx: cell {} of {} differs: {} '
                                 'against {}'.format(ref, part, gtext, text))
    return same, total, loose


def phase_program(settings):
    """Phase a: the whole program, ``python -m ysmr_tpu_torch <bench clip>
    --serial`` on cuda (stage 1, selection, evaluation, collation), its
    list held to the reference list, its stage outputs to ``analyse()`` on
    the reference list through the CSV restart path."""
    ini = program_ini(os.path.join(WORK, 'program.ini'), PROGRAM_SETTINGS)
    clip = os.path.join(WORK, 'bench_clip.avi')
    records, folder, wall = run_program('program', [clip, '--serial'], ini)
    end = [r for r in records if 'rc' in r][-1]
    stages = {}
    for r in records:
        if 'stage' in r:
            stages[r['stage']] = stages.get(r['stage'], 0.0) + r['s']
    plots = sorted({r['plot'] for r in records if 'plot' in r})
    launches = end['launches']
    log('program: python -m ysmr_tpu_torch bench_clip.avi --serial on cuda '
        'exited {}; wall {:.2f} s (the process, imports included), cli() '
        '{:.2f} s; stage wall s: {}; kernel launches {}; plot stub used by '
        '{} calls ({})'.format(end['rc'], wall, end['cli_s'],
                               json.dumps({k: round(v, 4)
                                           for k, v in stages.items()}),
                               json.dumps(launches),
                               sum('plot' in r for r in records),
                               ', '.join(plots)))
    run_cc_gate('program', launches)
    if 'violin_plot' not in plots:
        raise SystemExit('program: the plot stub was not used')
    ours = pd.read_csv(os.path.join(folder, 'bench_clip_list.csv'))
    hold_to_reference('program _list.csv', ours, 'bench_clip_list.csv.gz')
    import gzip
    with gzip.open(os.path.join(REPO, 'bench_data',
                                'bench_clip_list.csv.gz')) as f:
        ref_bytes = f.read()
    with open(os.path.join(folder, 'bench_clip_list.csv'), 'rb') as f:
        list_same = f.read() == ref_bytes
    # the CSV restart path on the reference list, in this process, under
    # the same ini; it runs no device work
    restart_in = os.path.join(WORK, 'restart_in')
    restart = os.path.join(WORK, 'restart')
    os.makedirs(restart_in)
    os.makedirs(restart)
    ref_csv = os.path.join(restart_in, 'bench_clip.csv')
    with open(ref_csv, 'wb') as f:
        f.write(ref_bytes)
    from ysmr_tpu_torch.main import analyse
    from ysmr_tpu_torch.utils.csv_io import collate_results_csv_to_xlsx
    rsettings = get_configs(ini)
    t0 = time.perf_counter()
    with PlotStub() as stub:
        ok = analyse(ref_csv, settings=rsettings, result_folder=restart,
                     device='cuda', fps=float(FPS), frame_height=H,
                     frame_width=W)
    restart_s = time.perf_counter() - t0
    if ok is not True:
        raise SystemExit('program: analyse() on the reference list failed')
    want_xlsx = collate_results_csv_to_xlsx(path=restart, save_path=restart)
    same = []
    for suffix in STAGE_SUFFIXES:
        same.append((suffix,) + csv_cells_match(
            'program ' + suffix,
            os.path.join(folder, 'bench_clip' + suffix),
            os.path.join(restart, 'bench_clip' + suffix)))
    (got_xlsx,) = [os.path.join(folder, n) for n in os.listdir(folder)
                   if n.endswith('_collated_statistics.xlsx')]
    cells = xlsx_match(got_xlsx, want_xlsx)
    log('program _list.csv: {} rows, row-identical to '
        'bench_data/bench_clip_list.csv.gz, byte-identical {}'.format(
            ours.shape[0], list_same))
    log('program stage outputs against analyse() on the reference list '
        '(CSV restart, {:.2f} s, {} stub plot calls): {}; collated xlsx {} '
        'of {} cells identical, the rest within 1e-9 but {} in {}'.format(
            restart_s, len(stub.calls), '; '.join(
                '{} byte-identical {}, rows identical {} of {}, held cells '
                'within {:.3e}, differing direction cells {}'.format(
                    r[0], r[1], r[2], r[3], r[4], json.dumps(r[5]))
                for r in same), *cells, DIRECTION_COLUMNS[0]))
    return launches


def fake_gui(keys):
    """cv2's window calls replaced; returns (restore, drawn window names).
    ``keys(n)`` is the key for the n-th drawn frame."""
    saved = {n: getattr(cv2, n) for n in ('imshow', 'waitKey', 'namedWindow',
                                          'destroyAllWindows')}
    env = {k: os.environ.get(k) for k in ('DISPLAY', 'WAYLAND_DISPLAY')}
    shown = []
    os.environ['DISPLAY'] = ':0'
    cv2.imshow = lambda name, img: shown.append(name)
    cv2.waitKey = lambda ms: keys(sum('unfiltered' in n for n in shown))
    cv2.namedWindow = lambda *a, **k: None
    cv2.destroyAllWindows = lambda: None

    def restore():
        for n, f in saved.items():
            setattr(cv2, n, f)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore, shown


def phase_display(settings):
    """Phase b: the live display on the card with a fake GUI on the bench
    clip: every frame drawn, the rows those of the device-rect path
    without the display, and 'q' after the second batch returns None."""
    clip = os.path.join(WORK, 'bench_clip.avi')
    plain = os.path.join(WORK, 'display_plain')
    os.makedirs(plain)
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings={**settings, 'cv2 exact rects': False},
                         result_folder=plain)
    plain_fps = N_FRAMES / (time.perf_counter() - t0)
    if res is None:
        raise SystemExit('display: the device-rect run returned None')
    with open(res[4], 'rb') as f:
        plain_bytes = f.read()
    disp = {**settings, 'display video analysis': True}
    for name in ('display', 'display_q'):
        os.makedirs(os.path.join(WORK, name))
    restore, shown = fake_gui(lambda n: 255)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = track_bacteria(clip, settings=dict(disp),
                             result_folder=os.path.join(WORK, 'display'))
        torch.cuda.synchronize()
        fps = N_FRAMES / (time.perf_counter() - t0)
        launches = {k.__name__: k.launches for k in KERNELS}
        drawn = sum('unfiltered possible detections' in n for n in shown)
    finally:
        restore()
    if res is None:
        raise SystemExit('display: track_bacteria returned None')
    with open(res[4], 'rb') as f:
        got = f.read()
    # 'q' on the first frame of the third batch of 16
    restore, shown = fake_gui(lambda n: ord('q') if n > 32 else 255)
    try:
        res_q = track_bacteria(clip, settings=dict(disp),
                               result_folder=os.path.join(WORK, 'display_q'))
        drawn_q = sum('unfiltered possible detections' in n for n in shown)
    finally:
        restore()
    log('display (fake GUI) on cuda, bench clip: {} of {} frames drawn, {} '
        'rows, _list.csv byte-identical to the device-rect path without the '
        'display (batch 16 against 64): {}; {:.2f} fps with the display, '
        '{:.2f} without; kernel launches {}; q after the second batch: '
        'returned {}, {} frames drawn'.format(
            drawn, N_FRAMES, got.count(b'\n') - 1, got == plain_bytes, fps,
            plain_fps, json.dumps(launches), res_q, drawn_q))
    if drawn != N_FRAMES:
        raise SystemExit('display: {} of {} frames drawn'.format(drawn,
                                                                 N_FRAMES))
    if got != plain_bytes:
        raise SystemExit('display: the batch size changed the rows')
    if res_q is not None or drawn_q != 33:
        raise SystemExit('display: q did not stop the run')
    if min(launches.values()) <= 0:
        raise SystemExit('display: a kernel of the path was never launched: '
                         '{}'.format(launches))


def phase_compact(dframes, dsettings):
    """Phase c: the compact emissions readback on the dense scene in memory
    (stage split; the bucket's growth and its padded batches) and on the
    dense clip through track_bacteria(path), against the padded readback
    of phase 7: byte-identical lists."""
    out = {}
    for compact in (False, True):
        _, got, stats = run_loop(
            dframes, {**dsettings, 'compact emissions readback': compact},
            'cuda', 'dense_compact_{}'.format(compact))
        out[compact] = (got, stats)
        log('dense scene in memory, {} readback (cuda): fps {:.2f}; bucket '
            'growth (first frame, old, new) {}; batches read padded {}; '
            'stage split (ms/frame): {}'.format(
                stats['readback'], stats['fps'], stats['bucket_growth'],
                stats['fallback_batches'], per_frame(stats)))
    if out[True][0] != out[False][0]:
        raise SystemExit('compact readback: _list.csv differs from padded')
    growth = out[True][1]['bucket_growth']
    if not growth or growth[0][1:] != (1024, 4096):
        raise SystemExit('compact readback: the bucket did not grow from '
                         '1024 to 4096: {}'.format(growth))
    folder = os.path.join(WORK, 'dense_clip_compact')
    os.makedirs(folder)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = track_bacteria(os.path.join(WORK, 'dense_clip.avi'),
                         settings={**dsettings,
                                   'compact emissions readback': True},
                         result_folder=folder)
    torch.cuda.synchronize()
    fps = DENSE_FRAMES / (time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in KERNELS}
    if res is None:
        raise SystemExit('compact readback: track_bacteria(path) returned '
                         'None')
    with open(res[4], 'rb') as f, open(os.path.join(
            WORK, 'dense_clip', 'dense_clip_list.csv'), 'rb') as g:
        same = f.read() == g.read()
    log('dense clip via track_bacteria(path) with the compact readback '
        '(cuda): _list.csv byte-identical to the padded readback of phase 7: '
        '{}; {:.2f} fps end to end; kernel launches {}'.format(
            same, fps, json.dumps(launches)))
    if not same:
        raise SystemExit('compact readback: the dense clip list differs')
    if min(launches.values()) <= 0:
        raise SystemExit('compact readback: a kernel was never launched')


def phase_det_px(scene, settings, dev):
    """Phase d: the run-CC branch's per-pixel detection index
    (``det_px_from_runs``) on cuda against cpu on the first bench batch."""
    packed, counts = packed_batch(scene, settings)
    runs, rc = encode(packed, counts, W, None)
    double = pp.resolve_detection_rule(settings)[0] == 'adaptive_double'
    kw = dict(h=H, w=W, double_threshold=double,
              max_det=settings['max detections per frame'],
              max_bh=settings['max bounding box height'], cc_iters=MAX_ITERS,
              use_run_cc=True, return_det_px=True, skip_rect=True,
              det_px_as_runs=False, expanded_f=packed.shape[1])
    out = {}
    for device in ('cuda', 'cpu'):
        args = (None, None, None, None,
                torch.ones(len(counts), dtype=torch.bool, device=device))
        wire = dict(px_runs=torch.from_numpy(runs.view(np.int32)).to(device),
                    run_counts=torch.from_numpy(rc).to(device))
        reset_run_cc()
        got = detect_from_pixels(*args, **wire, **kw)
        launches = run_cc_launches()
        ms = cuda_ms(lambda: detect_from_pixels(*args, **wire, **kw), 5) \
            if device == 'cuda' else None
        out[device] = ({k: got[k].cpu() for k in
                        ('det_px_idx', 'n_components', 'det_valid')},
                       launches, ms)
    same = all(torch.equal(out['cuda'][0][k], out['cpu'][0][k])
               for k in out['cpu'][0])
    det = out['cuda'][0]['det_px_idx']
    log('det_px_from_runs, first bench batch (64 x {}): cuda equals cpu {}; '
        '{} labelled pixels; run-CC kernel launches {}; detect with the '
        'per-pixel index {:.4f} ms on cuda'.format(
            packed.shape[1], same, int((det >= 0).sum()), out['cuda'][1],
            out['cuda'][2]))
    if not same:
        raise SystemExit('det_px_from_runs: cuda differs from cpu')
    run_cc_gate('det_px_from_runs', out['cuda'][1], double)


def phase_pool(settings):
    """Phase e: ysmr() with its spawn pool on the card (the program
    without --serial) on two short clips, against the serial run."""
    clips = [make_clip(os.path.join(WORK, 'pool_{}.avi'.format(i)), 64,
                       BenchScene(seed=SEED + 10 + i)) for i in range(2)]
    ini = program_ini(os.path.join(WORK, 'pool.ini'), {
        **PROGRAM_SETTINGS, 'minimal frame count': 32,
        'minimal length in seconds': 1.0,
        'limit track length to x seconds': 1.5,
        'collate results csv to xlsx': False})
    _, pool, pool_s = run_program('pool', clips, ini)
    _, serial, serial_s = run_program('pool_serial', clips + ['--serial'],
                                      ini)
    same = []
    for clip in clips:
        stem = os.path.splitext(os.path.basename(clip))[0]
        for suffix in ('_list.csv',) + STAGE_SUFFIXES:
            with open(os.path.join(pool, stem + suffix), 'rb') as f, \
                    open(os.path.join(serial, stem + suffix), 'rb') as g:
                same.append(f.read() == g.read())
    log('pool: python -m ysmr_tpu_torch on two 64-frame clips with spawn '
        'workers on cuda ({:.2f} s) against --serial ({:.2f} s): {} of {} '
        'CSVs byte-identical'.format(pool_s, serial_s, sum(same), len(same)))
    if not all(same):
        raise SystemExit('pool: the workers wrote other rows')


# ---- the parallel modes: multi-video sharding, the sharded assignment ----

#: phase 23's clips: bench scenes of these seeds and frame counts at full
#: width, and one bench scene cropped to 640x480 (a second group)
MV_CLIPS = ((123, 192), (126, 160), (127, 128), (128, 96))
MV_OTHER = (SEED + 6, 64, (640, 480))
MV_SETTINGS = {'frame batch size': 16, 'transfer mode': 'frames',
               'minimal frame count': 32}
MV_KERNELS = (row_min_argmin, hull_edge_vectors, sweep_extents,
              cc.label_components_whole_frame, cc.binary_reconstruct,
              ADAPTIVE_MASKS, COMPACT, gsff_ops.register_and_step,
              fs.match_and_register, rect.edge_finish, rect.rect_select)


def list_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def phase_multi_video(settings):
    """Phase 23: ``track_videos_sharded`` on cuda (frames mode, batch 16)
    over four full-width clips of uneven length and one 640x480 clip; each
    ``_list.csv`` against a solo ``track_bacteria(path)`` on cuda with the
    same settings: byte-identical. Returns {clip: list bytes}."""
    sets = {**settings, **MV_SETTINGS}
    t0 = time.perf_counter()
    clips = [make_clip(os.path.join(WORK, 'mv_{}.avi'.format(seed)), n,
                       BenchScene(seed=seed)) for seed, n in MV_CLIPS]
    seed, n_other, size = MV_OTHER
    other = make_clip(os.path.join(WORK, 'mv_other.avi'), n_other,
                      BenchScene(seed=seed), size=size)
    log('multi-video clips written in {:.1f} s: {} frames of {}x{} and {} '
        'of {}x{}'.format(time.perf_counter() - t0,
                          [n for _, n in MV_CLIPS], W, H, n_other, *size))
    paths = clips + [other]
    n_frames = sum(n for _, n in MV_CLIPS) + n_other
    solo_folder = os.path.join(WORK, 'mv_solo')
    os.makedirs(solo_folder)
    solo, solo_s = {}, {}
    for path in paths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = track_bacteria(path, settings=dict(sets),
                             result_folder=solo_folder)
        torch.cuda.synchronize()
        solo_s[path] = time.perf_counter() - t0
        if res is None:
            raise SystemExit('multi-video: solo track_bacteria returned None '
                             'for {}'.format(path))
        solo[path] = list_bytes(res[4])
    folder = os.path.join(WORK, 'mv_sharded')
    os.makedirs(folder)
    for k in MV_KERNELS + (pp.adaptive_gaussian_mean,):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = track_videos_sharded(paths, settings=dict(sets),
                               result_folder=folder, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in MV_KERNELS}
    batch = MV_SETTINGS['frame batch size']
    steps = -(-max(n for _, n in MV_CLIPS) // batch) + -(-n_other // batch)
    got = {}
    for path in paths:
        if out.get(path) is None:
            raise SystemExit('multi-video: no result for {}'.format(path))
        got[path] = list_bytes(out[path][4])
        if got[path] != solo[path]:
            raise SystemExit('multi-video: the sharded _list.csv of {} '
                             'differs from the solo run'.format(path))
        df = out[path][0]
        if not np.isfinite(df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all():
            raise SystemExit('multi-video: non-finite values')
    if min(launches.values()) <= 0:
        raise SystemExit('multi-video: a kernel of the path was never '
                         'launched: {}'.format(launches))
    # the tracker runs once over each device step's videos: one assign
    # launch per frame of a step, whatever the videos in it, and as many
    # of the other tracker kernels
    tracker_gate('multi-video ({} device steps)'.format(steps), launches,
                 steps * batch)
    # and one frames-mode detect per device step: one fused preprocess
    # launch and one compaction call, no int32 adaptive mean
    if launches['adaptive_masks_from_bgr'] != steps or \
            launches['compact_row_tables'] != steps or \
            pp.adaptive_gaussian_mean.launches:
        raise SystemExit('multi-video: {} fused preprocess launches and {} '
                         'compaction calls, not one per device step ({}); {} '
                         'int32 adaptive-mean launches'.format(
                             launches['adaptive_masks_from_bgr'],
                             launches['compact_row_tables'], steps,
                             pp.adaptive_gaussian_mean.launches))
    log('multi-video (phase 23): track_videos_sharded on cuda, {} clips, {} '
        'frames, {} device step(s) over a {}-device mesh: wall {:.2f} s, '
        '{:.2f} frames/s; solo track_bacteria(path) one after another {:.2f} '
        's ({:.2f} frames/s; per clip {}); every _list.csv byte-identical to '
        'its solo run ({} rows in all)'.format(
            len(paths), n_frames, steps, shd.device_count('cuda'), wall,
            n_frames / wall, sum(solo_s.values()),
            n_frames / sum(solo_s.values()),
            [round(v, 2) for v in solo_s.values()],
            sum(b.count(b'\n') - 1 for b in got.values())))
    log('multi-video kernel launches {} in {} steps, per step {}'.format(
        json.dumps(launches), steps, json.dumps(
            {k: round(v / steps, 2) for k, v in launches.items()})))
    return {p: got[p] for p in clips}


def phase_program_sharded(mv_lists):
    """Phase 24: ``python -m ysmr_tpu_torch <phase 23's four clips>`` with
    'shard videos across devices' in its tracking.ini, with --serial and
    without: exit 0, every clip's stage outputs, the lists those of phase
    23, and without --serial the pool replaced (one process ran every
    stage)."""
    ini = program_ini(os.path.join(WORK, 'sharded.ini'), {
        **PROGRAM_SETTINGS, **MV_SETTINGS,
        'minimal length in seconds': 1.0,
        'limit track length to x seconds': 1.5,
        'collate results csv to xlsx': False,
        'shard videos across devices': True})
    clips = list(mv_lists)
    for name, extra in (('program_sharded', ['--serial']),
                        ('program_sharded_pool', [])):
        records, folder, wall = run_program(name, clips + extra, ini)
        end = [r for r in records if 'rc' in r][-1]
        stages = {}
        for r in records:
            if 'stage' in r:
                stages[r['stage']] = stages.get(r['stage'], 0.0) + r['s']
        pids = {r['pid'] for r in records if 'stage' in r}
        for clip in clips:
            stem = os.path.splitext(os.path.basename(clip))[0]
            for suffix in ('_list.csv',) + STAGE_SUFFIXES:
                if not os.path.isfile(os.path.join(folder, stem + suffix)):
                    raise SystemExit('{}: {} missing'.format(name,
                                                             stem + suffix))
            if list_bytes(os.path.join(folder, stem + '_list.csv')) != \
                    mv_lists[clip]:
                raise SystemExit('{}: the _list.csv of {} differs from '
                                 'phase 23'.format(name, stem))
        with open(os.path.join(WORK, name + '.log')) as f:
            replaced = 'sharding replaces the process pool' in f.read()
        launches = end['launches']
        log('{}: python -m ysmr_tpu_torch <4 clips> {}with shard videos '
            'across devices: exit {}, wall {:.2f} s, cli() {:.2f} s, stage '
            'wall s {}, kernel launches {}, stage processes {}, the log says '
            'sharding replaced the pool: {}; every list byte-identical to '
            'phase 23'.format(name, ' '.join(extra) + ' ' if extra else '',
                              end['rc'], wall, end['cli_s'], json.dumps(
                                  {k: round(v, 4)
                                   for k, v in stages.items()}),
                              json.dumps(launches), len(pids), replaced))
        if stages.get('track_bacteria') or 'track_videos_sharded' not in \
                stages:
            raise SystemExit('{}: stage 1 did not run sharded'.format(name))
        if min(launches[k.__name__] for k in MV_KERNELS) <= 0:
            raise SystemExit('{}: a kernel of the path was never launched'
                             .format(name))
        if not extra and (not replaced or pids != {end['pid']}):
            raise SystemExit('{}: sharding did not replace the pool'.format(
                name))


def phase_sharded_assign(dframes, dsettings, dev):
    """Phase 25: ``sharded_greedy_assign`` on meshes that list the card 1,
    2 and 4 times at 16384 x 4096 (K = 2, 3) against the unsharded
    matcher; ``run_tracker_scan(assign_mesh=...)`` on the dense scene's
    first batch against the call without; the all_gather branch in a
    one-process NCCL group; the gate of ``track_bacteria`` on one card."""
    rng = np.random.default_rng(SEED)
    meshes = {n: shd.Mesh([dev] * n, ('slots',)) for n in (1, 2, 4)}
    for k in (2, 3):
        args = assign_inputs(rng, 16384, 4096, k, dev)
        want = assignment.greedy_assign_from_candidates(
            *row_min_argmin(*args), args[1], args[3])
        times = {'unsharded': cuda_ms(
            lambda: assignment.greedy_assign_from_candidates(
                *row_min_argmin(*args), args[1], args[3]), reps=5)}
        for n, mesh in meshes.items():
            got = shd.sharded_greedy_assign(mesh, *args)
            if not all(torch.equal(got[key], want[key]) for key in want):
                raise SystemExit('sharded assign differs on a {}-entry mesh '
                                 '(K = {})'.format(n, k))
            times[n] = cuda_ms(lambda: shd.sharded_greedy_assign(mesh, *args),
                               reps=5)
        log('sharded assign 16384 x 4096 K={}: bit-equal to the unsharded '
            'matcher on meshes of 1, 2, 4 entries; ms {}'.format(
                k, json.dumps({str(n): round(t, 4)
                               for n, t in times.items()})))

    t = 64
    bgr = torch.from_numpy(np.stack([cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
                                     for f in dframes[:t]])).to(dev)
    tables = detect.detect_batch(bgr, torch.ones(t, dtype=torch.bool,
                                                 device=dev),
                                 detect.DetectorConfig(dsettings))
    params = GSFFParams(fps=FPS, n_min=dsettings['minimum horizon size'],
                        n_max=dsettings['maximum horizon size'],
                        n_f=dsettings['number of LSFFs'])
    tkw = dict(max_disappeared=float(FPS), use_gsff=True,
               **trk.gsff_kwargs(params, dev))
    slots = dsettings['max track slots']
    out = {}
    for n in (None, 2, 4):
        state = trk.init_tracker_state(slots, dev, use_gsff=True,
                                       gsff_params=params)
        torch.cuda.synchronize()
        fs.match_and_register.launches = 0
        t0 = time.perf_counter()
        _, em = trk.run_tracker_scan(
            state, tables['det_xy'], tables['det_info'], tables['det_valid'],
            assign_mesh=meshes.get(n), **tkw)
        torch.cuda.synchronize()
        out[n] = (em, time.perf_counter() - t0)
        # the sharded candidates go through the frame-step kernel too
        if fs.match_and_register.launches != t:
            raise SystemExit('run_tracker_scan with mesh {}: {} frame-step '
                             'launches for {} frames'.format(
                                 n, fs.match_and_register.launches, t))
    for n in (2, 4):
        if not all(torch.equal(out[n][0][key], out[None][0][key])
                   for key in out[None][0]):
            raise SystemExit('run_tracker_scan with a {}-entry mesh differs'
                             .format(n))
    log('run_tracker_scan on the dense scene first batch ({} frames, {} '
        'slots, {} live emissions): with a mesh of 2 and 4 entries equal '
        'to the call without, one frame-step launch a frame; wall s {}'.format(
            t, slots, int(out[None][0]['mask'].sum()), json.dumps(
                {str(n): round(v[1], 4) for n, v in out.items()})))

    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    if not shd.init_distributed('127.0.0.1:{}'.format(port), 1, 0,
                                device='cuda'):
        raise SystemExit('init_distributed did not start a group')
    try:
        mesh = shd.make_mesh(axis='slots', device='cuda')
        args = assign_inputs(rng, 16384, 4096, 2, dev)
        want = assignment.greedy_assign_from_candidates(
            *row_min_argmin(*args), args[1], args[3])
        got = shd.sharded_greedy_assign(mesh, *args)
        same = all(torch.equal(got[key], want[key]) for key in want)
        log('NCCL group of one process: {} (world {}, backend {}); the '
            'all_gather branch equals the unsharded matcher: {}'.format(
                mesh, mesh.world, torch.distributed.get_backend(), same))
    finally:
        torch.distributed.destroy_process_group()
    if not same or mesh.world != 1:
        raise SystemExit('the NCCL all_gather branch differs')

    clip = os.path.join(WORK, 'pool_0.avi')
    calls = []
    real = shd.sharded_row_min_argmin
    shd.sharded_row_min_argmin = lambda *a, **kw: calls.append(1) or \
        real(*a, **kw)
    try:
        folder = os.path.join(WORK, 'gate')
        os.makedirs(folder)
        row_min_argmin.launches = 0
        res = track_bacteria(clip, settings={
            **dsettings, 'cv2 exact rects': False, 'minimal frame count': 32,
            'shard dense assignment across devices': True,
            'dense assignment shard threshold': 0}, result_folder=folder)
    finally:
        shd.sharded_row_min_argmin = real
    if res is None or calls or row_min_argmin.launches <= 0:
        raise SystemExit('the dense-assignment gate engaged on one card')
    log('track_bacteria with shard dense assignment across devices '
        '(threshold 0) on {} card(s): the gate stays shut (sharded calls {}, '
        'assign launches {})'.format(shd.device_count('cuda'), len(calls),
                                      row_min_argmin.launches))


def phase_keep_and_entry(scene, settings, dev):
    """Phase 26: ``run_cc.keep_marked_runs`` through the kernel on the
    bench batch against its plain version (the same runs on the CPU):
    bit-equal; one step of ``graft_entry.entry('cuda')`` against
    ``entry('cpu')``; ``graft_entry.dryrun_multichip(4)`` on ``cuda``."""
    runs, rc = first_batch_runs(scene, settings)
    wire = [torch.from_numpy(runs.view(np.int32)), torch.from_numpy(rc)]
    reset_run_cc()
    got = run_cc.keep_marked_runs(*(a.to(dev) for a in wire), w=W)
    launches = run_cc_launches()
    want = run_cc.keep_marked_runs(*wire, w=W)
    if launches != {'propagate_min_fused': 1, 'prepare_runs': 1,
                    'compact_kept_runs': 0, 'finish_components': 0} or \
            not torch.equal(got.cpu(), want):
        raise SystemExit('keep_marked_runs: the kernel differs from the '
                         'plain version (launches {})'.format(launches))
    ms = cuda_ms(lambda: run_cc.keep_marked_runs(*(a.to(dev) for a in wire),
                                                 w=W), reps=5)
    log('keep_marked_runs, first bench batch ({} x {} runs): kernel bit-equal '
        'to the plain version, {} of {} runs kept; {:.4f} ms on cuda (with '
        'the upload)'.format(runs.shape[0], runs.shape[1], int(got.sum()),
                             int(rc.sum()), ms))
    ems = {}
    for device in ('cuda', 'cpu'):
        fn, args = graft_entry.entry(device=device)
        ems[device] = {k: v.cpu() for k, v in fn(*args)[1].items()}
    c, p = ems['cuda'], ems['cpu']
    pos = float((c['pos'] - p['pos']).abs().max())
    if not all(torch.equal(c[k], p[k]) for k in ('mask', 'ids', 'det_col',
                                                   'n_det')) or pos > POS_TOL:
        raise SystemExit('graft_entry.entry: cuda differs from cpu')
    log('graft_entry.entry on cuda: {} live emissions over {} frames, mask '
        'and ids equal to the cpu step, positions within {:.2e}'.format(
            int(c['mask'].sum()), c['mask'].shape[0], pos))
    graft_entry.dryrun_multichip(4)
    log('graft_entry.dryrun_multichip(4) on cuda (a mesh listing {} card(s) '
        'in turn): the multi-video step and the sharded assignment equal '
        'their one-device results'.format(shd.device_count('cuda')))


# ---- the tracker batched over the video axis ----

#: phase 27's batched assign calls: (V, R, C, K, timed); with V > 1 video 1
#: has no valid row and the last video no valid detection
BATCHED_ASSIGN = ((4, 1024, 512, 2, True), (4, 1024, 512, 3, True),
                  (4, 4096, 4096, 2, True), (4, 4096, 4096, 3, True),
                  (5, 1001, 700, 2, False), (1, 1001, 700, 3, False),
                  (3, 77, 0, 2, False))


def assign_batch(rng, v, r, c, k, dev):
    """V problems of ``assign_inputs`` stacked on a leading video axis
    (made with at least 8 detections, which it marks valid, then cut to
    C)."""
    parts = [[a.cpu().numpy() for a in assign_inputs(rng, r, max(c, 8), k,
                                                     'cpu')]
             for _ in range(v)]
    obj, ov, det, dv = (np.stack(x) for x in zip(*parts))
    det, dv = det[:, :c], dv[:, :c]
    if v > 1:
        ov[1] = False
        dv[-1] = False
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (obj, ov, det, dv))


def check_batched_assign(rng, dev):
    """The batched assign kernel: one launch per call, bit-equal to its
    plain version and to V single launches; at V = 4 its time beside the
    four single launches and ``torch.cdist(...).min(-1)`` over the batch
    (two calls, a yardstick: it takes the invalid rows and columns too)."""
    for v, r, c, k, timed in BATCHED_ASSIGN:
        args = assign_batch(rng, v, r, c, k, dev)
        before = row_min_argmin.launches
        got = row_min_argmin(*args)
        torch.cuda.synchronize()
        if row_min_argmin.launches != before + 1:
            raise SystemExit('batched assign: {} launches for one call'
                             .format(row_min_argmin.launches - before))
        want = assignment.row_min_argmin_plain(*args)
        singles = [row_min_argmin(*(a[i] for a in args)) for i in range(v)]
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want)) and all(
            torch.equal(got[j][i], singles[i][j])
            for i in range(v) for j in range(2))
        if not same:
            raise SystemExit('batched assign V={} {}x{} K={}: differs from '
                             'the plain version or the single launches (max '
                             '|diff| {})'.format(v, r, c, k,
                                                 max_abs_err(got, want)))
        what = 'batched assign V={} {}x{} K={}'.format(v, r, c, k)
        if not timed:
            log('{}: one launch, bit-equal to the plain version and to the '
                'single launch of each of its {} video(s)'.format(what, v))
            continue
        ms = cuda_ms(lambda: row_min_argmin(*args), reps=20)
        views = [tuple(a[i] for a in args) for i in range(v)]
        singles_ms = cuda_ms(lambda: [row_min_argmin(*x) for x in views],
                             reps=20)
        obj, det = args[0], args[2]
        cdist_ms = cuda_ms(lambda: torch.cdist(obj, det).min(-1), reps=20)
        bnd = bound(args, got, assign_ops(args[1], args[3], k))
        log('{}: one launch, bit-equal to the plain version and to {} single '
            'launches; ms batched {:.4f}, {} single launches {:.4f}, bound '
            '{:.3g} ({})'.format(what, v, ms, v, singles_ms, *bnd))
        log('{}: torch.cdist(obj, det).min(-1) over the batch (two calls, '
            'invalid rows and columns included) {:.4f} ms'.format(what,
                                                                cdist_ms))


def dense_tracker_inputs(dframes, dsettings, dev, t=64):
    """The dense scene's first ``t`` frames through the frames-mode detect
    on the card: the tracker's (det_xy, det_info, det_valid) tables, the
    GSFF bank of the settings and ``run_tracker_scan``'s keywords."""
    bgr = torch.from_numpy(np.stack([cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
                                     for f in dframes[:t]])).to(dev)
    tables = detect.detect_batch(bgr, torch.ones(t, dtype=torch.bool,
                                                 device=dev),
                                 detect.DetectorConfig(dsettings))
    params = GSFFParams(fps=FPS, n_min=dsettings['minimum horizon size'],
                        n_max=dsettings['maximum horizon size'],
                        n_f=dsettings['number of LSFFs'])
    tkw = dict(max_disappeared=float(FPS), use_gsff=True,
               **trk.gsff_kwargs(params, dev))
    return [tables[k] for k in ('det_xy', 'det_info', 'det_valid')], params, \
        tkw


def phase_batched_tracker(dframes, dsettings, dev):
    """Phase 27: the batched assign kernel (``check_batched_assign``), then
    the dense scene's first batch (64 frames at the dense capacities, GSFF)
    split into four pseudo-videos of 16 frames: one batched
    ``run_tracker_scan`` on cuda against the four per-video scans on cuda,
    every emission and state tensor bit-equal; assign launches 16 against
    64, and the wall time per frame step of each."""
    check_batched_assign(np.random.default_rng(SEED + 27), dev)
    t, v = 64, 4
    tables, params, tkw = dense_tracker_inputs(dframes, dsettings, dev, t)
    split = [x.reshape((v, t // v) + tuple(x.shape[1:])) for x in tables]
    slots = dsettings['max track slots']

    def fresh():
        return trk.init_tracker_state(slots, dev, use_gsff=True,
                                      gsff_params=params)

    # warm-up: one batched and one single scan of two frames
    trk.run_tracker_scan(shd.stack_states([fresh()] * v),
                         *(x[:, :2] for x in split), **tkw)
    trk.run_tracker_scan(fresh(), *(x[0, :2] for x in split), **tkw)
    runs = {}
    for name in ('batched', 'per video'):
        row_min_argmin.launches = 0
        fs.match_and_register.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == 'batched':
            out = trk.run_tracker_scan(shd.stack_states([fresh()] * v),
                                       *split, **tkw)
        else:
            out = [trk.run_tracker_scan(fresh(), *(x[i] for x in split),
                                        **tkw) for i in range(v)]
        torch.cuda.synchronize()
        runs[name] = (out, time.perf_counter() - t0,
                      row_min_argmin.launches)
        if fs.match_and_register.launches != row_min_argmin.launches:
            raise SystemExit('batched tracker scan ({}): {} frame-step '
                             'launches, {} assign launches'.format(
                                 name, fs.match_and_register.launches,
                                 row_min_argmin.launches))
    (b_state, b_em), b_s, b_launches = runs['batched']
    singles, s_s, s_launches = runs['per video']
    for i, (st, em) in enumerate(singles):
        for key in em:
            if not torch.equal(b_em[key][i], em[key]):
                raise SystemExit('batched tracker scan: {} of pseudo-video '
                                 '{} differs from its own scan'.format(key, i))
        both = shd._tree_map(lambda a, b: torch.equal(a[i], b), b_state, st)
        flat = [x for x in both.values() if not isinstance(x, dict)] + \
            list(both['gsff'].values())
        if not all(flat):
            raise SystemExit('batched tracker scan: the state of pseudo-video '
                             '{} differs from its own scan'.format(i))
    if b_launches != t // v or s_launches != t:
        raise SystemExit('batched tracker scan: assign launches {} / {}, '
                         'not {} / {}'.format(b_launches, s_launches, t // v,
                                              t))
    log('batched tracker scan, dense first batch as {} pseudo-videos of {} '
        'frames ({} slots, {} live emissions): bit-equal to the per-video '
        'scans on cuda (every emission and state tensor); assign launches '
        '{} against {}; wall {:.4f} s ({:.3f} ms per frame step of {} '
        'videos) against {:.4f} s ({:.3f} ms per frame step of one)'.format(
            v, t // v, slots, int(b_em['mask'].sum()), b_launches,
            s_launches, b_s, b_s / (t // v) * 1e3, v, s_s, s_s / t * 1e3))


# ---- the adaptive mean ----

#: phase 28's edge shapes and value ranges (tests/test_torch_preprocess.py):
#: one pixel, H and W under the 11 taps, a partial 16-frame chunk of the
#: plain version with W past a 64-column tile, partial tiles at full size
MEAN_EDGES = ((1, 1, 1), (3, 7, 5), (17, 33, 129), (2, 921, 1227))
MEAN_WIDE = (-70000, 70001)


def conv_mean(img):
    """The yardstick of the adaptive mean, not bit-equal: two 1-D float32
    convolutions (cuDNN, TF32 off) over a replicate-padded batch, then
    ``floor(acc + 0.5)``."""
    k = torch.from_numpy(pp._K11_F32).to(img.device)
    x = torch.nn.functional.pad(img.to(torch.float32)[:, None],
                                (5, 5, 5, 5), mode='replicate')
    x = torch.nn.functional.conv2d(x, k.view(1, 1, 1, 11))
    x = torch.nn.functional.conv2d(x, k.view(1, 1, 11, 1))
    return torch.floor(x + 0.5).to(torch.int32)[:, 0]


#: phase 28's frames for the fused pass besides the scenes'
#: (tests/test_torch_preprocess.py's MASK_SHAPES and its W % 4 != 0 batch):
#: bands and 112-column strips crossed, 2 rows, 2 columns, one row, one
#: column, one pixel, byte-wise loads and stores; one row past a band with
#: one lane group past a strip (words), two bands and a row with one
#: column past a strip (bytes), one band of two strips and 2 columns; at
#: full width one row past a band and the bench width plus one column
MASK_EDGES = ((3, 70, 133), (3, 2, 130), (3, 67, 2), (2, 130, 260),
              (3, 1, 130), (3, 67, 1), (3, 1, 1), (2, 921, 1227),
              (2, 65, 116), (2, 129, 113), (2, 64, 226), (2, 65, 1228),
              (2, 922, 1229))
#: (mode, white on dark, offset, double delta, gray) of the fused checks
#: besides the bench configuration: both rules, white and dark, offsets on
#: both sides of the ceil and floor edges, with and without the gray
MASK_RULES = (('adaptive_double', True, 2.5, 1.25, True),
              ('adaptive_double', False, -1.5, 2.0, True),
              ('adaptive', True, 5, 0.5, False),
              ('adaptive', False, 2.5, 1.25, True))


def masks_outputs(out):
    return tuple(o for o in out if o is not None)


def check_masks(name, bgr, valid, rule, timed=False):
    """The fused pass (``adaptive_masks_from_bgr``) against its plain
    version on the card, bit-equal, one launch a call; with ``timed`` the
    ``check_equal`` record (median ms of each, the bound: the BGR of the
    valid frames read once, or of every frame with the gray, frame_valid,
    the outputs written once; 44 float32 and about 20 integer operations a
    pixel, counted at the float32 rate)."""
    mode, white, offset, delta, gray = rule
    args = (bgr, valid, mode, offset, delta, white, gray)
    n, h, w = bgr.shape[:3]
    if timed:
        read = n if gray else int(valid.sum())
        nbytes = read * h * w * 3 + n + n * h * w * (
            1 + (mode == 'adaptive_double') + 4 * gray)
        return check_equal(
            'adaptive masks ' + name,
            lambda *a: masks_outputs(pp.adaptive_masks_from_bgr(*a)),
            lambda *a: masks_outputs(pp.adaptive_masks_from_bgr_plain(*a)),
            args, 64 * n * h * w, plain_reps=3, nbytes=nbytes)
    before = pp.adaptive_masks_from_bgr.launches
    got = pp.adaptive_masks_from_bgr(*args)
    want = pp.adaptive_masks_from_bgr_plain(*args)
    torch.cuda.synchronize()
    if pp.adaptive_masks_from_bgr.launches != before + 1 or any(
            (g is None) != (v is None) or
            (g is not None and not torch.equal(g, v))
            for g, v in zip(got, want)):
        raise SystemExit('adaptive masks {} {}: kernel != plain (launches '
                         '{})'.format(name, rule,
                                      pp.adaptive_masks_from_bgr.launches -
                                      before))
    return None


def launch_args(fn, kernel):
    """The profiler's arguments (registers, shared memory, estimated
    achieved occupancy) of the first launch whose name holds ``kernel`` in
    a traced call of ``fn``."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        for ev in events:
            if ev.get('cat') == 'kernel' and kernel in ev['name']:
                return ev.get('args', {})
    return {}


def phase_adaptive_mean(scene, settings, dscene, dev):
    """Phase 28: both entries of ``csrc/adaptive_mean.cu`` against their
    plain versions on the card, bit-equal. The int32 adaptive mean on the
    blurred first 64 frames of the bench and dense scenes, a 16-frame
    640x480 batch (a device step of phase 23's second group), the edge
    shapes with values in 0-255 and in +-70,000, with the ``F.conv2d``
    yardstick; its own path, ``detect_from_blurred`` on the bench batch,
    one launch, the tables those of ``detect_batch``'s fused route. The
    fused pass on the same three BGR batches (the bench configuration
    timed with and without the gray, both rules, white and dark, a padded
    batch) and on the edge shapes. Median ms, bounds and shares logged,
    and each kernel's resources. Returns the int32 entry's bench check,
    its yardstick ms and its launches on its path, and the fused entry's
    bench check."""
    cfg = detect.DetectorConfig(settings)
    bench_rule = (cfg.mode, cfg.white_on_dark, cfg.offset, cfg.double_delta,
                  False)
    seed, _, (ow, oh) = MV_OTHER
    other = BenchScene(seed=seed)
    batches = (
        ('bench 64x922x1228', bgr_batch(
            [scene.frame(t) for t in range(64)], dev)),
        ('dense 64x922x1228', bgr_batch(
            [dscene.frame(t) for t in range(64)], dev)),
        ('640x480 16 frames', bgr_batch(
            [other.frame(t)[:oh, :ow] for t in range(16)], dev)))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        checks = []
        for name, bgr in batches:
            img = detect.prepare_batch(bgr)[1]
            check = check_equal(
                'adaptive mean ' + name,
                lambda x: (pp.adaptive_gaussian_mean(x),),
                lambda x: (pp.adaptive_gaussian_mean_plain(x),), [img],
                44 * img.numel(), plain_reps=3)
            conv_ms = cuda_ms(lambda: conv_mean(img))
            off = int((conv_mean(img) != pp.adaptive_gaussian_mean(img))
                      .sum())
            log('adaptive mean {}: kernel {:.4f} ms, {:.1f}% of the bound '
                '{:.4f} ms ({}); plain {:.4f} ms; F.conv2d yardstick {:.4f} '
                'ms ({} of {} pixels differ from the kernel)'.format(
                    name, check[1], 100 * check[3][0] / check[1],
                    check[3][0], check[3][1], check[2], conv_ms, off,
                    img.numel()))
            checks.append((check, conv_ms))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rng = np.random.default_rng(SEED)
    for span in ((0, 256), MEAN_WIDE):
        for shape in MEAN_EDGES:
            img = torch.from_numpy(rng.integers(*span, shape).astype(
                np.int32)).to(dev)
            pp.adaptive_gaussian_mean.launches = 0
            got = pp.adaptive_gaussian_mean(img)
            want = pp.adaptive_gaussian_mean_plain(img)
            torch.cuda.synchronize()
            if pp.adaptive_gaussian_mean.launches != 1 or \
                    not torch.equal(got, want):
                raise SystemExit('adaptive mean {} values {}: kernel != '
                                 'plain (launches {})'.format(
                                     shape, span,
                                     pp.adaptive_gaussian_mean.launches))
    log('adaptive mean edge shapes {} with values in 0-255 and in +-70,000: '
        'kernel bit-equal to the plain version, one launch a call'.format(
            list(MEAN_EDGES)))
    masks_checks = []
    for name, bgr in batches:
        n = bgr.shape[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        main = check_masks(name, bgr, valid, bench_rule, timed=True)
        with_gray = check_masks(name + ' with the gray', bgr, valid,
                                bench_rule[:4] + (True,), timed=True)
        for chk, what in ((main, 'mask and markers'),
                          (with_gray, 'mask, markers and gray')):
            log('adaptive masks {} ({}): kernel {:.4f} ms, {:.1f}% of the '
                'bound {:.4f} ms ({}); plain {:.4f} ms'.format(
                    name, what, chk[1], 100 * chk[3][0] / chk[1],
                    chk[3][0], chk[3][1], chk[2]))
        for rule in MASK_RULES:
            check_masks(name, bgr, valid, rule)
        padded = torch.arange(n, device=dev) < n - 3
        for rule in (bench_rule, MASK_RULES[1]):
            check_masks(name + ' padded', bgr, padded, rule)
        masks_checks.append(main)
    rng = np.random.default_rng(SEED + 40)
    for shape in MASK_EDGES:
        bgr = torch.from_numpy(rng.integers(0, 256, shape + (3,),
                                            dtype=np.uint8)).to(dev)
        valid = torch.arange(shape[0], device=dev) != 1
        for rule in (bench_rule,) + MASK_RULES:
            check_masks('x'.join(map(str, shape)), bgr, valid, rule)
    log('adaptive masks: kernel bit-equal to the plain version, one launch '
        'a call, on the three batches ({} and {} rules each, a padded '
        'batch) and on the edge shapes {} with a padded frame'.format(
            bench_rule, len(MASK_RULES), list(MASK_EDGES)))
    # the int32 entry's own path: detect_from_blurred, the JAX function's
    # counterpart, against detect_batch's fused route
    bgr = batches[0][1]
    valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
    pp.adaptive_gaussian_mean.launches = 0
    pp.adaptive_masks_from_bgr.launches = 0
    gray, blurred = detect.prepare_batch(bgr)
    old = detect.detect_from_blurred(
        gray, blurred, valid, None, mode=cfg.mode,
        white_on_dark=cfg.white_on_dark, offset=cfg.offset,
        double_delta=cfg.double_delta, max_det=cfg.max_det,
        max_bh=cfg.max_bh, cc_iters=cfg.cc_iters)
    mean_launches = pp.adaptive_gaussian_mean.launches
    new = detect.detect_batch(bgr, valid, cfg)
    torch.cuda.synchronize()
    if (mean_launches, pp.adaptive_masks_from_bgr.launches) != (1, 1) or \
            pp.adaptive_gaussian_mean.launches != 1:
        raise SystemExit('adaptive mean: detect_from_blurred and detect_batch '
                         'launched {} int32 and {} fused preprocess '
                         'kernels'.format(pp.adaptive_gaussian_mean.launches,
                                          pp.adaptive_masks_from_bgr.launches))
    for key in old:
        if not torch.equal(old[key], new[key]):
            raise SystemExit('adaptive mean: detect_from_blurred and '
                             'detect_batch differ in {}'.format(key))
    log('adaptive mean: detect_from_blurred on the bench batch (one int32 '
        'adaptive-mean launch) gives detect_batch\'s tables (one fused '
        'launch), bit for bit')
    lib = _build.load_kernels()
    img = detect.prepare_batch(bgr)[1]
    # (name, ptxas' entry, threads a block, call): the fused entry's bench
    # instantiation (words, two rules) without and with the gray
    for name, entry, threads, call in (
            ('masks_kernel', 'masks_kernelILb1ELb1ELb0E', 32,
             lambda: pp.adaptive_masks_from_bgr(
                 bgr, valid, *(bench_rule[i] for i in (0, 2, 3, 1)))),
            ('masks_kernel with the gray', 'masks_kernelILb1ELb1ELb1E', 32,
             lambda: pp.adaptive_masks_from_bgr(
                 bgr, valid, *(bench_rule[i] for i in (0, 2, 3, 1)),
                 want_gray=True)),
            ('mean_kernel', 'mean_kernel', 128,
             lambda: pp.adaptive_gaussian_mean(img))):
        ptx = ptxas_of(lib.build_log, 'adaptive_mean.cu', entry)
        args = launch_args(call, name.split()[0])
        rec = {'kernel': name, 'source': 'adaptive_mean.cu'}
        if ptx is not None:
            regs, spill, _ = ptx
            smem = int(args.get('shared memory') or 0)
            rec.update(registers=regs, spill_stores=spill, shared_bytes=smem,
                       occupancy_allowed=resident_share(regs, smem, threads))
        rec['achieved_occupancy_pct'] = args.get(
            'est. achieved occupancy %')
        log('adaptive mean resources ' + json.dumps(rec))
    return checks[0], masks_checks[0]


# ---- the GSFF block ----

#: phase 29's edge cases (tests/test_torch_gsff.py's cuda twin): name,
#: slots, GSFFParams keywords besides fps, kind of slots, coordinate span
GSFF_EDGES = (
    ('N = 1', 1, {}, 'mixed', 400), ('N = 4095', 4095, {}, 'mixed', 400),
    ('all inactive', 4096, {}, 'inactive', 400),
    ('all registering', 4096, {}, 'registering', 400),
    ('n_max 256, n_f 8', 1024, {'n_max': 256, 'n_f': 8}, 'mixed', 400),
    ('+-1e4 px', 4096, {}, 'mixed', 1e4),
    ('n_max 33', 1024, {'n_max': 33}, 'mixed', 400),
    ('n_max 64', 1024, {'n_max': 64}, 'mixed', 400))


def gsff_case(rng, n, params, dev, kind='mixed', span=400):
    """``register_and_step``'s arguments on the card for a random mid-run
    state of ``n`` slots (tests/test_torch_gsff.py::_mixed_case): rings
    that random-walk from up to ``span`` px (shifted into +-span beyond
    1228), the modes the ring allows, a third of them lower, matched,
    coasting, registering and inactive slots mixed (or all inactive, or
    all registering)."""
    st = {k: v.numpy() for k, v in gsff_ops.init_state(params, n,
                                                        'cpu').items()}
    width = min(span, W)
    base = rng.uniform(50, width, (n, 1, 2))
    if span > W:
        base = base + rng.uniform(-span, span - W, (n, 1, 1))
    st['buf'] = (base + np.cumsum(rng.normal(0, 1, (n, params.buf_len, 2)),
                                  axis=1)).astype(np.float32)
    st['buf_lo'] = (rng.uniform(-1, 1, st['buf'].shape) * 1e-6).astype(
        np.float32)
    st['len'] = rng.integers(0, params.buf_len + 1, n).astype(np.int32)
    mode = (st['len'][:, None] >= np.asarray(params.n_i)[None]).sum(1)
    low = (rng.random(n) < 0.3) & (mode > 0)
    st['mode'] = np.where(low, rng.integers(0, np.maximum(mode, 1)),
                          mode).astype(np.int32)
    st['log_w'] = np.where(
        np.arange(params.n_f)[None] < st['mode'][:, None],
        np.log(rng.dirichlet(np.ones(params.n_f), n)),
        gsff_ops.NEG_INF).astype(np.float32)
    st['pred_lo'] = (rng.uniform(-1, 1, (n, 2)) * 1e-6).astype(np.float32)
    meas = (st['buf'][:, -1] + rng.normal(0, 1, (n, 2))).astype(np.float32)
    sort = rng.integers(0, 4, n)  # matched, coasting, registering, inactive
    active, reg, coast = sort != 3, sort == 2, sort == 1
    if kind == 'inactive':
        active, reg, coast = (np.zeros(n, bool),) * 3
    elif kind == 'registering':
        active, reg, coast = np.ones(n, bool), np.ones(n, bool), \
            np.zeros(n, bool)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (params.gains_on(dev),
            torch.tensor(params.n_i, dtype=torch.int32, device=dev),
            params.n_f, params.n_i[0], {k: put(v) for k, v in st.items()},
            put(meas), put(active), put(reg), put(coast))


def gsff_ops_count(args):
    """Float operations of one GSFF step on its active slots: two windows
    of 2 n_max double-single differences (11 operations each), 4 n_f dots
    of a double-single product (24) and add (11) per entry (the tree's
    adds and the center's), and about 60 per filter for the weights and
    sums."""
    gains, _, n_f, _, _, _, active = args[:7]
    w2 = gains.shape[-1]
    per = 2 * 11 * w2 + 4 * n_f * 35 * w2 + 60 * n_f
    return int(active.sum()) * per


def gsff_tensors(args):
    gains, n_i, _, _, state, m, active, reg, coast = args
    return [gains, n_i] + [state[k] for k in gsff_ops.STATE_KEYS] + \
        [m, active, reg, coast]


def gsff_outputs(out):
    state, corrected, predicted = out
    return [state[k] for k in gsff_ops.STATE_KEYS] + [corrected, predicted]


def check_gsff(name, args, timed=False):
    """The GSFF kernel against its plain version on the same card tensors:
    every output bit-equal, one launch, the inputs untouched; with
    ``timed``, median ms of each and the bound (``check_equal``)."""
    before = [x.clone() for x in gsff_tensors(args)]
    gsff_ops.register_and_step.launches = 0
    got = gsff_outputs(gsff_ops.register_and_step(*args))
    want = gsff_outputs(gsff_ops.register_and_step_plain(*args))
    torch.cuda.synchronize()
    if gsff_ops.register_and_step.launches != 1:
        raise SystemExit('gsff {}: {} launches, not 1'.format(
            name, gsff_ops.register_and_step.launches))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit('gsff {}: kernel != plain (max |diff| {})'.format(
            name, max_abs_err(got, want)))
    if not all(torch.equal(a, b) for a, b in zip(gsff_tensors(args),
                                                  before)):
        raise SystemExit('gsff {}: the kernel wrote into its inputs'.format(
            name))
    if not timed:
        return None
    return check_equal(
        'gsff ' + name,
        lambda *_: gsff_outputs(gsff_ops.register_and_step(*args)),
        lambda *_: gsff_outputs(gsff_ops.register_and_step_plain(*args)),
        gsff_tensors(args), gsff_ops_count(args), reps=20)


def frame_step(v, params, dev, plain, k=2):
    """``tracker_step_launches.measure`` (the dense frame step: 4096
    slots, 4096 detections, 3000 live) at V videos and K coordinates with
    the GSFF kernel or, with ``plain``, its plain version swapped in:
    (device operations of the step (kernels, memsets, copies), median ms
    per frame step, the operations by name, the device operations each
    profile of the one- and two-frame scans recorded); the first and
    third are None where no two profiles of a scan agreed."""
    kernel = gsff_ops._register_and_step
    if plain:
        gsff_ops._register_and_step = gsff_ops._register_and_step_plain
    try:
        out = tsl.measure(trk, params, v, dev, k)
    finally:
        gsff_ops._register_and_step = kernel
    ops = None if out['frame_step'] is None else \
        out['frame_step']['kernels'] + out['frame_step']['memops']
    return (ops, out['ms_per_frame_step'], out['frame_step_ops'],
            out['device_ops_of_each_profile'])


#: device operations (kernels, memsets, copies) of a dense frame step:
#: assign, the frame step's rank and update, GSFF (which writes the live
#: positions itself)
MAX_STEP_OPS = 4


def phase_gsff(dframes, dsettings, settings, dev):
    """Phase 29: the GSFF kernel against its plain version on the card:
    each frame step's call of the dense first batch and that scan with the
    plain version swapped in, random mid-run states at N = 4096 (timed,
    with the bound) and 4 x 1024, the edge cases; the dense frame step's
    kernels and wall time at V = 1 and 4 with the kernel and with the
    plain version. Returns the timed dense-batch check."""
    t = 64
    tables, params, tkw = dense_tracker_inputs(dframes, dsettings, dev, t)
    slots = dsettings['max track slots']
    kernel = gsff_ops._register_and_step
    calls, scans = [], {}
    for name in ('kernel', 'plain'):
        def record(gains, n_i, n_f, n_i0, state, pos, *masks, out, frame,
                   emit_pos=None, step=gsff_ops._register_and_step_plain
                   if name == 'plain' else kernel):
            # the public entry's arguments, copied: the scan's buffers
            # are rewritten by the frames that follow
            calls.append((gains, n_i, n_f, n_i0,
                          {k: x.clone() for k, x in state.items()},
                          pos[:, :2].contiguous()) +
                         tuple(x.clone() for x in masks))
            return step(gains, n_i, n_f, n_i0, state, pos, *masks, out=out,
                        frame=frame, emit_pos=emit_pos)
        gsff_ops._register_and_step = record
        try:
            scans[name] = trk.run_tracker_scan(
                trk.init_tracker_state(slots, dev, use_gsff=True,
                                       gsff_params=params), *tables, **tkw)
        finally:
            gsff_ops._register_and_step = kernel
    torch.cuda.synchronize()
    (k_state, k_em), (p_state, p_em) = scans['kernel'], scans['plain']
    same = [torch.equal(k_em[key], p_em[key]) for key in k_em] + \
        [torch.equal(k_state['gsff'][key], p_state['gsff'][key])
         for key in gsff_ops.STATE_KEYS] + \
        [torch.equal(k_state[key], p_state[key]) for key in k_state
         if key != 'gsff']
    if len(calls) != 2 * t or not all(same):
        raise SystemExit('gsff: the dense first batch with the kernel differs '
                         'from the scan with the plain version ({} calls)'
                         .format(len(calls)))
    for i, args in enumerate(calls[:t]):
        check_gsff('dense first batch, frame {}'.format(i), args)
    live = int(calls[t // 2][6].sum())
    dense = check_gsff('dense first batch, frame {} ({} active of {} '
                       'slots)'.format(t // 2, live, slots), calls[t // 2],
                       timed=True)
    log('gsff: the dense first batch ({} frames, {} live emissions) with the '
        'kernel bit-equal to the scan with the plain version; each frame '
        'step\'s call bit-equal to the plain version on its inputs'.format(
            t, int(k_em['mask'].sum())))
    rng = np.random.default_rng(SEED + 29)
    bench = GSFFParams(fps=FPS, n_min=settings['minimum horizon size'],
                       n_max=settings['maximum horizon size'],
                       n_f=settings['number of LSFFs'])
    check_gsff('random mid-run state, N = 4096',
               gsff_case(rng, slots, params, dev), timed=True)
    check_gsff('random mid-run state, 4 x 1024 (a device step of phase 23)',
               gsff_case(rng, 4 * settings['max track slots'], bench, dev),
               timed=True)
    for name, n, bank, kind, span in GSFF_EDGES:
        check_gsff(name, gsff_case(rng, n, GSFFParams(fps=FPS, **bank), dev,
                                   kind, span))
    log('gsff edge cases {}: kernel bit-equal to the plain version, one '
        'launch a call, inputs untouched'.format([e[0] for e in GSFF_EDGES]))
    default = GSFFParams(fps=FPS)
    for v, k in ((1, 2), (4, 2), (1, 3)):
        step = {name: frame_step(v, default, dev, name == 'plain', k)
                for name in ('kernel', 'plain')}
        log('gsff: dense frame step at V = {}, K = {}: {} device operations '
            'and {:.3f} ms with the GSFF kernel ({}; each profile\'s '
            'operations {}), {} operations and {:.3f} ms with its plain '
            'version'.format(
                v, k, step['kernel'][0], step['kernel'][1],
                json.dumps(step['kernel'][2]), step['kernel'][3],
                *step['plain'][:2]))
        if step['kernel'][0] is None or \
                not 1 <= step['kernel'][0] <= MAX_STEP_OPS:
            raise SystemExit('gsff: the dense frame step at V = {}, K = {} '
                             'runs {} device operations, not 1 to {} ({}; '
                             'each profile\'s operations {})'.format(
                                 v, k, step['kernel'][0], MAX_STEP_OPS,
                                 json.dumps(step['kernel'][2]),
                                 step['kernel'][3]))
    return dense


# ---- the frame step's match-and-register block ----

#: phase 30's seeded cases (tests/test_torch_frame_step.py): stale ids in
#: free slots, quantised positions (row-minimum ties), an empty frame,
#: more and fewer detections than tracks, a full table that drops
#: registrations, two active slots that share an id; and their shapes
#: (V, S, C, K)
STEP_CASES = ('stale_ids', 'ties', 'empty', 'more_dets', 'fewer_dets',
              'full', 'shared_id')
STEP_SHAPES = ((1, 16, 24, 2), (3, 48, 40, 3), (3, 96, 64, 2),
               (1, 64, 96, 3), (3, 0, 40, 2), (2, 4095, 4097, 2),
               (1, 1, 1, 3), (4, 1500, 1700, 3))


def step_video(rng, case, s, c, k):
    """One video's slot table and frame for ``case`` as numpy; ``dense``:
    3000 live tracks of 4096 slots at full width and 3000 detections
    within about a pixel of them."""
    if case == 'dense':
        active = np.zeros(s, bool)
        active[rng.choice(s, 3000, replace=False)] = True
        next_id = 20000
        scale, quant = W, False
    else:
        live = {'full': 0.75, 'fewer_dets': 0.8}.get(case, 0.5)
        active = rng.random(s) < live
        next_id = int(rng.integers(3 * s, 5 * s + 2))
        scale, quant = 60, case == 'ties'
    n_obj = int(active.sum())
    ids = rng.integers(0, next_id, s).astype(np.int32)
    ids[active] = rng.choice(next_id, n_obj, replace=False)
    if case == 'shared_id' and n_obj >= 2:
        on = np.nonzero(active)[0]
        ids[on[1]] = ids[on[0]]
    pos = rng.uniform(0, scale, (s, k))
    pos = np.round(pos / 4) * 4 if quant else pos
    n_det = {'more_dets': min(c, n_obj + 1 + s // 4),
             'fewer_dets': max(0, n_obj - 1 - s // 4), 'full': c,
             'empty': 0, 'dense': 3000}.get(case, int(rng.integers(0, c + 1)))
    det_xy = rng.uniform(0, scale, (c, k))
    if n_obj:
        near = rng.random(c) < (1.0 if case == 'dense' else 0.5)
        src = pos[rng.choice(np.nonzero(active)[0], c)]
        det_xy = np.where(near[:, None], src + rng.normal(0, 1.5, (c, k)),
                          det_xy)
    det_xy = np.round(det_xy / 4) * 4 if quant else det_xy
    det_valid = np.zeros(c, bool)
    det_valid[rng.choice(c, n_det, replace=False)] = True
    state = {'active': active, 'ids': ids, 'pos': pos.astype(np.float32),
             'info': rng.uniform(1, 8, (s, 3)).astype(np.float32),
             'disappeared': np.where(active, rng.integers(0, 40, s),
                                     0).astype(np.int32),
             'next_id': np.int32(next_id),
             'dropped_registrations': np.int32(rng.integers(0, 4))}
    frame = (det_xy.astype(np.float32),
             rng.uniform(1, 8, (c, 3)).astype(np.float32), det_valid)
    return state, frame


def step_inputs(rng, case, shape, dev):
    """V videos of ``case`` on the card: (state, frame, row_min, cand),
    the candidates from the assign kernel on the slot table as it is."""
    v, s, c, k = shape
    videos = [step_video(rng, case, s, c, k) for _ in range(v)]

    def put(arrays):
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrays))).to(
            dev)

    state = {key: put([st[key] for st, _ in videos]) for key in fs.STATE_KEYS}
    frame = [put([f[i] for _, f in videos]) for i in range(3)]
    return (state, frame) + row_min_argmin(state['pos'], state['active'],
                                           frame[0], frame[2])


def same_bits(a, b):
    """Whether two tensors hold the same bits (NaN payloads included)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def step_outputs(res):
    new_state, emission = res[:2]
    return [new_state[k] for k in fs.STATE_KEYS] + \
        [emission[k] for k in fs.EMISSION_KEYS] + list(res[2:])


def check_step(name, state, frame, row_min, cand, md=float(FPS),
               timed=False, cpu_plain=False):
    """The frame-step kernel against its plain version on the same card
    tensors (with ``cpu_plain``, on copies on the CPU): every output
    bit-equal, one call counted, the inputs untouched; with ``timed``,
    median ms of each and the bound (bytes in and out; operations: a key
    comparison per pair of live slots)."""
    inputs = [state[k] for k in fs.STATE_KEYS] + [row_min, cand] + \
        list(frame)
    before = [x.clone() for x in inputs]

    def kernel(*_):
        return step_outputs(fs.match_and_register(
            state, row_min, cand, *frame, max_disappeared=md))

    def plain(*_):
        return step_outputs(fs.match_and_register_plain(
            state, row_min, cand, *frame, max_disappeared=md))

    def plain_cpu():
        return [x.to(row_min.device) for x in step_outputs(
            fs.match_and_register_plain(
                {k: x.cpu() for k, x in state.items()}, row_min.cpu(),
                cand.cpu(), *(x.cpu() for x in frame), max_disappeared=md))]

    fs.match_and_register.launches = 0
    got, want = kernel(), (plain_cpu() if cpu_plain else plain())
    torch.cuda.synchronize()
    if fs.match_and_register.launches != 1:
        raise SystemExit('frame step {}: {} launches, not 1'.format(
            name, fs.match_and_register.launches))
    if not all(same_bits(g, w) for g, w in zip(got, want)):
        raise SystemExit('frame step {}: kernel != plain (max |diff| '
                         '{})'.format(name, max_abs_err(got, want)))
    if not all(same_bits(a, b) for a, b in zip(inputs, before)):
        raise SystemExit('frame step {}: the kernel wrote into its '
                         'inputs'.format(name))
    if not timed:
        return None
    live = state['active'].sum(dim=1).double()
    return check_equal('frame step ' + name, kernel, plain, inputs,
                       int((live * live).sum()), reps=20)


def device_ms(fn, reps=20):
    """Mean device ms per call of each kernel ``fn`` launches, by name, and
    the median device span of a call (its first launch's start to its
    last one's end; launches may overlap) (``torch.profiler`` over
    ``reps`` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a profile now and then records no device operation at all (seen on
    # the H100 after several profiles in one process): take another
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, ranges = {}, []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.name] = out.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / reps
                ranges.append((e.time_range.start, e.time_range.end))
        if ranges:
            break
    ranges.sort()
    per = len(ranges) // reps
    spans = [max(b for _, b in ranges[i:i + per]) - ranges[i][0]
             for i in range(0, per * reps, per)] if per else [0]
    return out, float(np.median(spans)) / 1e3


def step_split(name, state, frame, row_min, cand, md=float(FPS)):
    """The frame-step kernel's two launches timed apart on the card
    (``device_ms``), each beside its bound: rank reads the live flags, row
    minima and ids and writes the ranks, a key comparison per pair of
    live slots of a video; update reads the rest of the inputs and the
    ranks and writes the outputs (bytes). Returns {launch: (ms, bound
    ms, bound by)}."""
    v, s = state['active'].shape
    c = frame[2].shape[1]
    k = state['pos'].shape[2]
    times, span = device_ms(lambda: fs.match_and_register(
        state, row_min, cand, *frame, max_disappeared=md))
    live = state['active'].sum(dim=1).double()
    rank_bytes = v * s * (1 + 4 + 4 + 4)
    # inputs: the slot table (active, ids, pos, info, disappeared), the
    # candidates and ranks, the detections; outputs: the new state, the
    # emission row (mask, ids, pos, info, det_col), the flags
    update_bytes = v * (s * (1 + 4 + 4 * k + 12 + 4 + 4 + 4) +
                        c * (4 * k + 12 + 1) +
                        s * (1 + 4 + 4 * k + 12 + 4) +
                        s * (1 + 4 + 4 * k + 12 + 4) + 3 * s) + 4 * 5 * v
    rank_ops = float((live * live).sum())
    out = {}
    for launch, nbytes, ops in (('rank', rank_bytes, rank_ops),
                                ('update', update_bytes, 0.0)):
        ms = sum(t for n, t in times.items() if launch + '_kernel' in n)
        bnd = bound([], [], ops, nbytes)
        out[launch] = (ms,) + bnd
        log('frame step {}: {} launch {:.4f} ms on the card, bound {:.5f} ms '
            '({})'.format(name, launch, ms, *bnd))
    if not all(out[x][0] > 0 for x in out):
        raise SystemExit('frame step {}: a launch was not traced ({})'.format(
            name, sorted(times)))
    # the update launch starts programmatically during the rank launch:
    # the pair's cost is its device span
    bnd = bound([], [], rank_ops, rank_bytes + update_bytes)
    out['span'] = (span,) + bnd
    log('frame step {}: rank + update device span {:.4f} ms, bound {:.5f} '
        'ms ({})'.format(name, span, *bnd))
    return out


def phase_frame_step(dframes, dsettings, dev):
    """Phase 30: the frame-step kernel (``csrc/frame_step.cu``) against
    ``match_and_register_plain`` on the card, bit for bit: every frame
    step of the dense first batch (the plain version's state fed to both;
    the whole scan with the plain block swapped in too), random states at
    the dense size for V = 1 and 4 (timed, with the bound), and the edge
    cases of tests/test_torch_frame_step.py. Returns the timed dense-batch
    check."""
    t = 64
    tables, params, tkw = dense_tracker_inputs(dframes, dsettings, dev, t)
    slots = dsettings['max track slots']
    md = tkw['max_disappeared']
    kernel = fs._match_and_register
    calls, scans, counts = [], {}, {}

    def record(state, row_min, cand, *tables, max_disappeared, out, frame):
        calls.append(({k: state[k].clone() for k in fs.STATE_KEYS},
                      tables, row_min.clone(), cand.clone()))
        return fs.write_plain(out, frame, fs.match_and_register_plain(
            state, row_min, cand, *tables, max_disappeared=max_disappeared))

    for name in ('kernel', 'plain'):
        fs.match_and_register.launches = 0
        row_min_argmin.launches = 0
        fs._match_and_register = record if name == 'plain' else kernel
        try:
            scans[name] = trk.run_tracker_scan(
                trk.init_tracker_state(slots, dev, use_gsff=True,
                                       gsff_params=params), *tables, **tkw)
        finally:
            fs._match_and_register = kernel
        counts[name] = (fs.match_and_register.launches,
                        row_min_argmin.launches)
    torch.cuda.synchronize()
    (k_state, k_em), (p_state, p_em) = scans['kernel'], scans['plain']
    same = [torch.equal(k_em[key], p_em[key]) for key in k_em] + \
        [torch.equal(k_state['gsff'][key], p_state['gsff'][key])
         for key in gsff_ops.STATE_KEYS] + \
        [torch.equal(k_state[key], p_state[key]) for key in k_state
         if key != 'gsff']
    if len(calls) != t or not all(same) or counts['kernel'] != (t, t) or \
            counts['plain'] != (0, t):
        raise SystemExit('frame step: the dense first batch with the kernel '
                         'differs from the scan with the plain version ({} '
                         'calls; launches {})'.format(len(calls), counts))
    t0 = time.perf_counter()
    for i, (state, frame, row_min, cand) in enumerate(calls):
        check_step('dense first batch, frame {}'.format(i), state, frame,
                   row_min, cand, md)
    state, frame, row_min, cand = calls[t // 2]
    dense = check_step('dense first batch, frame {} ({} live of {} '
                       'slots)'.format(t // 2, int(state['active'].sum()),
                                       slots), state, frame, row_min, cand,
                       md, timed=True)
    log('frame step (phase 30): the dense first batch ({} frames, {} live '
        'emissions) with the kernel bit-equal to the scan with the plain '
        'block (frame-step launches {}, assign {}); each frame step bit-equal '
        'to the plain version on its inputs ({:.1f} s)'.format(
            t, int(k_em['mask'].sum()), *counts['kernel'],
            time.perf_counter() - t0))
    step_split('dense first batch, frame {}'.format(t // 2), state, frame,
               row_min, cand, md)
    rng = np.random.default_rng(SEED + 30)
    for v in (1, 4):
        args = step_inputs(rng, 'dense', (v, slots, slots, 2), dev)
        check_step('random dense state, V = {}'.format(v), *args,
                   timed=True)
        step_split('random dense state, V = {}'.format(v), *args)
    t0 = time.perf_counter()
    n = 0
    for case in STEP_CASES:
        for shape in STEP_SHAPES:
            args = step_inputs(rng, case, shape, dev)
            check_step('{} {}'.format(case, shape), *args, md=5.0)
            n += 1
    state, frame, row_min, cand = step_inputs(rng, 'ties', (1, 48, 40, 2),
                                              dev)
    on = torch.nonzero(state['active'][0]).flatten()
    row_min[0, on[::3]] = float('nan')
    check_step('NaN row minima', state, frame, row_min, cand, md=5.0)
    state, frame, row_min, cand = step_inputs(rng, 'empty', (1, 16, 24, 2),
                                              dev)
    state['active'].fill_(True)
    state['disappeared'].fill_(2 ** 24 - 1)
    check_step('max_disappeared in float32', state, frame, row_min, cand,
               md=16777215.9)
    for edge in fsc.KEY_EDGES:
        for shape in ((1, 96, 64, 2), (1, slots, slots, 2)):
            state, frame, row_min, cand = step_inputs(rng, 'more_dets',
                                                      shape, dev)
            fsc.key_edges(edge, state, row_min, cand)
            # torch's CUDA stable sort orders NaNs by their bits (a
            # negative NaN first); its CPU sort, ysmr_tpu's and the
            # kernel's put every NaN after +inf, equal
            check_step('key edge {} {}'.format(edge, shape), state, frame,
                       row_min, cand, md=5.0,
                       cpu_plain=edge == 'nan_payloads')
    log('frame step edge cases ({} seeded at shapes {}, NaN row minima, '
        'the float32 max_disappeared, no slots, the key edges {}): kernel '
        'bit-equal to the plain version, one call a check, inputs untouched '
        '({:.1f} s)'.format(n, list(STEP_SHAPES), list(fsc.KEY_EDGES),
                            time.perf_counter() - t0))
    return dense


# ---- phase 31: the rect tail's kernels (csrc/cv2_centers.cu, rect.cu) ----

def rect_tail_inputs(hull_args, sweep_args):
    """The three rect-tail kernels' inputs from the hull and sweep inputs
    of a batch (``dense_tables``, ``frames_tables``): the cv2-centre
    tables with the hull's corners and the inverse-sqrt table, the hull's
    chain outputs, and the sweep's extents with the edge candidates (the
    (1, 0) implicit) and the finished edges' angles and validity."""
    r = hull_args[0].shape[1]
    chains = hull_edge_vectors(*hull_args)
    isq = cv2c.inv_sqrt_table(labeling._CV2_CENTER_MAX_EDGE_W, r,
                              device=hull_args[0].device)
    cv2_args = hull_args + (chains[6], chains[7], isq)
    _, _, ang, valid = rect.edge_finish(*chains[:6])
    select_args = sweep_extents(*sweep_args) + sweep_args[6:] + (ang, valid)
    return cv2_args, chains[:6], select_args


def rect_tail_edge_tables(dev):
    """The seeded edge cases of ``rect_tail_cases`` as row tables (R =
    160), then seeded random tables (also with holes)."""
    r = rtc.EDGE_CASE_ROWS
    tabs = [(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in rtc.row_tables(rtc.edge_case_blobs(), r)), r)]
    rng = np.random.default_rng(SEED + 31)
    for dd, rr, holes in ((4097, 48, False), (3001, 96, True),
                          (33, 2, False)):
        tabs.append((random_row_tables(rng, dd, rr, dev, holes), rr))
    return tabs


def sweep_of(hull_args):
    """The sweep's inputs of row tables: the tables, the stats tail's
    corners and edge candidates."""
    return rect_inputs(hull_args)[1]


def cv2_ok_view(outs):
    """The cv2-centre outputs that are compared: ``ok`` everywhere, the
    centres' bits where it holds (nothing reads them elsewhere)."""
    ok = outs[2]
    return (ok,) + tuple(t[ok].view(torch.int32) for t in outs[:2])


def cv2_cost(args, ok):
    """Operations and bytes of the cv2-centre call on this data. The u/v
    projection loop: per component of n > 2 strict corners, n x n (edge,
    vertex) pairs of two products, a sum and two min/max. Bytes: row_valid
    of every (component, row); the two int32 tables and both corner flags
    only at the valid rows (the kernel reads no other row of them); min_y
    and the 9 output bytes of every component; the inverse square roots of
    the at most 8 candidates of each ``ok`` component."""
    rvalid = args[2]
    n = (args[4].sum(1) + args[5].sum(1)).to(torch.int64)
    ops = int((n * n * (n > 2)).sum()) * 6
    nbytes = rvalid.numel() + int(rvalid.sum()) * 10 + \
        rvalid.shape[0] * 13 + int((n.clamp(max=8) * ok).sum()) * 4
    return ops, nbytes


def edge_finish_cost(chains):
    """Operations and bytes of the edge-finish call on this data: about 40
    operations at a kept slot; the edge flag and the 13 output bytes
    (three float32, a flag) of every slot, the vector's 8 bytes only at a
    kept slot."""
    d, r = chains[0].shape
    keep = int(chains[2][:, :r - 1].sum() + chains[5][:, :r - 1].sum())
    return keep * 40, d * 2 * (r - 1) * 14 + keep * 8


def rect_select_cost(select_args):
    """Operations and bytes of the rect-select call on this data: about
    100 operations per valid candidate (the appended one included); the
    validity byte of every candidate, the 7 float32 values (extents,
    direction, angle) of a valid one, the appended candidate's 4 extents
    (its direction and angle are formed) and the 20 output bytes of every
    component."""
    evalid = select_args[7]
    n_valid = int(evalid.sum())
    d = evalid.shape[0]
    return (n_valid + d) * 100, evalid.numel() + n_valid * 28 + d * 36


def rect_tail_uneven(dev):
    """The cases of ``rect_tail_cases`` that split the new layouts
    unevenly, as (name, cv2 args, R, select args): the band octagons and
    the table-edge squares (with its 26-entry table) padded with empty
    components to D = 4 k + 1 and 4 k + 3, seeded random tables at R =
    1000 (too tall to stage), and the rect select's synthetic cases."""
    out = []
    r = 48
    for name, blobs, table in (('band octagons', rtc.band_blobs(), None),
                               ('table-edge squares', rtc.table_edge_blobs(),
                                rtc.TABLE_EDGE)):
        for odd in (1, 3):
            pad = (odd - len(blobs)) % 4 + 4
            hull_args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                dev) for a in rtc.row_tables(blobs + [None] * pad, r))
            cv2_args, _, select_args = rect_tail_inputs(hull_args,
                                                        sweep_of(hull_args))
            if table:
                cv2_args = cv2_args[:6] + (cv2c.inv_sqrt_table(
                    *table, device=dev),)
            out.append(('{} D={}'.format(name, hull_args[0].shape[0]),
                        cv2_args, r, select_args))
    tall = random_row_tables(np.random.default_rng(SEED + 32), 301, 1000,
                             dev)
    cv2_args, _, select_args = rect_tail_inputs(tall, sweep_of(tall))
    out.append(('random D=301 R=1000', cv2_args, 1000, select_args))
    rng = np.random.default_rng(SEED + 33)
    for name, k, d, frac in rtc.SELECT_CASES:
        out.append(('select ' + name, None, None, tuple(
            torch.from_numpy(a).to(dev) for a in
            rtc.select_arrays(rng, k, d, frac))))
    return out


def ptxas_of(log_text, source, kernel):
    """(registers, spill stores, shared bytes) of the first entry of
    ``source`` whose name holds ``kernel`` in the build's ptxas report."""
    unit, entry, regs, spill = None, False, None, None
    for line in log_text.splitlines():
        if line.endswith('.cu:'):
            unit = line[:-1]
        elif unit == source and 'Compiling entry' in line:
            if regs is not None:
                break
            entry = kernel in line
        elif unit == source and entry and 'spill stores' in line:
            spill = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif unit == source and entry and 'Used' in line:
            regs = int(line.split('Used ')[1].split(' registers')[0])
            smem = int(line.split(' bytes smem')[0].split(',')[-1]) \
                if 'bytes smem' in line else 0
    if regs is None:
        return None
    return regs, spill, smem


def resident_share(regs, smem, threads):
    """The occupancy ptxas' registers and shared memory allow on an H100
    (registers allocated 256 a warp, 64 K a SM, 228 KB of shared memory
    with 1 KB reserved a block, 32 blocks and 64 warps a SM)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * warps), 32, 64 // warps,
                 (228 * 1024) // (smem + 1024))
    return blocks * warps / 64


def achieved_occupancy(fn, kernel):
    """The profiler's estimate of achieved occupancy (%) of the first
    launch whose name holds ``kernel`` in a traced call of ``fn``."""
    return launch_args(fn, kernel).get('est. achieved occupancy %')


def phase_rect_tail(scene, settings, dscene, dsettings, dframes, dev):
    """Phase 31: the cv2-centre kernel (``csrc/cv2_centers.cu``) and the
    edge-finish and rect-select kernels (``csrc/rect.cu``; the rect
    select's (1, 0) implicit) against their plain versions on the card,
    one launch a call: on the dense first batch's tables, the frames-mode
    bench batch and the seeded edge cases; then the dense first batch's
    ``_list.csv`` with the plain blocks swapped in, byte-identical to the
    kernels'. Returns the dense batch's timed checks."""
    dense = dense_tables(*first_batch_runs(dscene, dsettings), dsettings,
                         dev)
    frames = frames_tables(scene, settings, dev)
    cases = [('dense batch', dense), ('frames-mode bench batch', frames)]
    for i, (hull_args, r) in enumerate(rect_tail_edge_tables(dev)):
        cases.append(('edge cases {} (D={} R={})'.format(
            i, hull_args[0].shape[0], r), (hull_args, sweep_of(hull_args))))
    out = {}
    for name, (hull_args, sweep_args) in cases:
        cv2_args, chains, select_args = rect_tail_inputs(hull_args,
                                                         sweep_args)
        reps = 20 if name == 'dense batch' else 3
        before = [k.launches for k in (cv2c.cv2_centers_from_tables,
                                       rect.edge_finish, rect.rect_select)]
        r = cv2_args[0].shape[1]
        ops, nbytes = cv2_cost(cv2_args, cv2c.cv2_centers_from_tables_plain(
            *cv2_args, max_bh=r)[2])
        checks = [check_equal(
            'cv2 centres ' + name,
            lambda *a: cv2c.cv2_centers_from_tables(*a, max_bh=r),
            lambda *a: cv2c.cv2_centers_from_tables_plain(*a, max_bh=r),
            cv2_args, ops, reps=reps, plain_reps=3, nbytes=nbytes,
            view=cv2_ok_view)]
        ops, nbytes = edge_finish_cost(chains)
        checks.append(check_equal(
            'edge finish ' + name, rect.edge_finish,
            labeling.edge_finish_plain, chains, ops, reps=reps,
            plain_reps=3, nbytes=nbytes))
        ops, nbytes = rect_select_cost(select_args)
        checks.append(check_equal(
            'rect select ' + name, rect.rect_select,
            labeling.rect_select_plain, select_args, ops, reps=reps,
            plain_reps=3, nbytes=nbytes))
        after = [k.launches for k in (cv2c.cv2_centers_from_tables,
                                      rect.edge_finish, rect.rect_select)]
        if any(a <= b for a, b in zip(after, before)):
            raise SystemExit('rect tail {}: a kernel was not launched'.format(
                name))
        if name == 'dense batch':
            out = dict(zip(('cv2_centers_from_tables', 'edge_finish',
                            'rect_select'), checks))
            # (wrapper, source, ptxas' and the profiler's kernel name,
            # threads a block, the call on this batch)
            dense_calls = (
                (sweep_extents, 'sweep.cu',
                 ('sweep_kernelILi3E', 'sweep_kernel<3>'), 256,
                 lambda a=sweep_args: sweep_extents(*a)),
                (cv2c.cv2_centers_from_tables, 'cv2_centers.cu',
                 ('cv2_centers_kernel',) * 2, 128,
                 lambda a=cv2_args, rr=r: cv2c.cv2_centers_from_tables(
                     *a, max_bh=rr)),
                (rect.rect_select, 'rect.cu', ('rect_select_kernel',) * 2,
                 256, lambda a=select_args: rect.rect_select(*a)))
    for name, cv2_args, r, select_args in rect_tail_uneven(dev):
        before = [k.launches for k in (cv2c.cv2_centers_from_tables,
                                       rect.rect_select)]
        if cv2_args is not None:
            ops, nbytes = cv2_cost(cv2_args, cv2c.cv2_centers_from_tables_plain(
                *cv2_args, max_bh=r)[2])
            check_equal(
                'cv2 centres ' + name,
                lambda *a: cv2c.cv2_centers_from_tables(*a, max_bh=r),
                lambda *a: cv2c.cv2_centers_from_tables_plain(*a, max_bh=r),
                cv2_args, ops, reps=3, plain_reps=1, nbytes=nbytes,
                view=cv2_ok_view)
        ops, nbytes = rect_select_cost(select_args)
        check_equal('rect select ' + name, rect.rect_select,
                    labeling.rect_select_plain, select_args, ops, reps=3,
                    plain_reps=1, nbytes=nbytes)
        after = [k.launches for k in (cv2c.cv2_centers_from_tables,
                                      rect.rect_select)]
        if after[1] <= before[1] or (cv2_args is not None and
                                     after[0] <= before[0]):
            raise SystemExit('rect tail {}: a kernel was not launched'.format(
                name))
    # each redesigned kernel's resources at the dense batch
    lib = _build.load_kernels()
    for fn, source, kernel, threads, call in dense_calls:
        ptx = ptxas_of(lib.build_log, source, kernel[0])
        rec = {'kernel': fn.__name__, 'source': source}
        if ptx is not None:
            regs, spill, smem = ptx
            rec.update(registers=regs, spill_stores=spill, shared_bytes=smem,
                       occupancy_allowed=resident_share(regs, smem, threads))
        rec['achieved_occupancy_pct'] = achieved_occupancy(call, kernel[1])
        log('rect tail resources ' + json.dumps(rec))
    # the dense first batch through the stage-1 loop, kernels against the
    # plain blocks swapped in
    from ysmr_tpu_torch.ops import hull as hull_mod
    from ysmr_tpu_torch.ops import sweep as sweep_mod
    swaps = ((cv2c, 'cv2_centers_from_tables',
              cv2c.cv2_centers_from_tables_plain),
             (rect, 'edge_finish', labeling.edge_finish_plain),
             (rect, 'rect_select', labeling.rect_select_plain),
             (hull_mod, 'hull_edge_vectors', labeling.hull_tables_plain),
             (sweep_mod, 'sweep_extents', labeling.sweep_tables_plain))
    lists = {}
    for how in ('kernels', 'plain'):
        saved = [getattr(m, n) for m, n, _ in swaps]
        if how == 'plain':
            for m, n, fn in swaps:
                setattr(m, n, fn)
        try:
            reset_launches()
            _, lists[how], _ = run_loop(dframes[:64], dsettings, 'cuda',
                                        'rect_tail_' + how)
            launches = [k.launches for k in saved]
        finally:
            for (m, n, _), fn in zip(swaps, saved):
                setattr(m, n, fn)
        if launches != [int(how == 'kernels')] * len(swaps):
            raise SystemExit('rect tail, {}: launches {}'.format(how,
                                                                  launches))
    if lists['kernels'] != lists['plain']:
        raise SystemExit('rect tail: the dense first batch differs with the '
                         'plain blocks swapped in')
    log('rect tail: the dense first batch _list.csv ({} rows) byte-identical '
        'with the kernels (one launch each) and with the plain blocks '
        '(hull, sweep, edge finish, rect select, cv2 centres) swapped '
        'in'.format(lists['plain'].count(b'\n') - 1))
    return out


# ---- phase 32: frames mode's compaction and row tables (csrc/compact.cu) --

def compact_inputs(frames, settings, dev):
    """The labels and mask frames mode's detect hands the compaction, from
    gray frames: the fused preprocess, the reconstruction and the
    8-connected labeling on the card."""
    cfg = detect.DetectorConfig(settings)
    bgr = bgr_batch(frames, dev)
    valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
    mask, markers, _ = pp.adaptive_masks_from_bgr(
        bgr, valid, cfg.mode, cfg.offset, cfg.double_delta,
        cfg.white_on_dark)
    if markers is not None:
        mask = cc.binary_reconstruct(mask, markers)
    return cc.label_components_whole_frame(mask, 8), mask


def compact_bits(labels, mask):
    """The packed mask the labeling hands frames mode's compaction (the
    labeling run once more for its bits), or None in a checkout whose
    labeling does not return it."""
    if 'return_bits' not in inspect.signature(
            cc.label_components_whole_frame).parameters:
        return None
    got, bits = cc.label_components_whole_frame(mask, 8, return_bits=True)
    if not torch.equal(got, labels):
        raise SystemExit('the labeling with its bits differs')
    return bits


def check_compact(name, labels, mask, max_det, max_bh, timed=False,
                  bits=None):
    """The compaction kernel against its plain version on the same card
    tensors, every output bit-equal, one call (reading ``bits``, the packed
    mask, where given, as frames mode's detect does); with ``timed``,
    median ms of each, the device time by kernel and the call's device
    span, and the bound (the mask read once, the labels at its foreground
    pixels, the outputs written once: the same count with the packed
    mask)."""
    kw = {} if bits is None else {'fg_bits': bits}

    def kernel(*_):
        return COMPACT(labels, mask, max_det=max_det, max_bh=max_bh, **kw)

    def plain(*_):
        return labeling.compact_row_tables_plain(labels, mask,
                                                 max_det=max_det,
                                                 max_bh=max_bh)

    n = COMPACT.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if COMPACT.launches != n + 1 or \
            not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit('compact {}: kernel != plain (max |diff| {}) or {} '
                         'calls'.format(name, max_abs_err(got, want),
                                        COMPACT.launches - n))
    if not timed:
        return None
    nbytes = mask.numel() + 4 * int(mask.sum()) + sum(
        int(o.numel()) * o.element_size() for o in got)
    check = check_equal('compact ' + name, kernel, plain, [labels, mask], 0,
                        reps=20, plain_reps=3, nbytes=nbytes)
    per, span = device_ms(kernel)
    log('compact {}: device {:.4f} ms ({}), event span {:.4f} ms, bound '
        '{:.4f} ms ({:.1f}% of the device time); components {}, foreground '
        'pixels {}'.format(
            name, span, json.dumps({k[:40]: round(v, 4)
                                    for k, v in per.items()}),
            check[1], check[3][0], 100 * check[3][0] / max(span, 1e-9),
            int(got[4].sum()), int(mask.sum())))
    return check


def phase_compaction(frames, settings, dframes, dsettings, dev):
    """Phase 32: the compaction kernel (``csrc/compact.cu``) against its
    plain version on the card, bit for bit: the bench batch (timed, with
    the bound), the dense scene's frames batch and a 16-frame 640x480
    batch (a device step of phase 23's second group), each as frames
    mode's detect gives it, and the seeded edge cases of
    ``compact_cases.py`` (more components than max_det, a component
    taller than max_bh, empty frames, frames of one row and one column,
    components on every frame edge, frames under 32 pixels). Returns the
    bench check."""
    seed, _, (ow, oh) = MV_OTHER
    other = BenchScene(seed=seed)
    checks, bench = [], None
    for name, frs, sets in (
            ('bench 64x922x1228', frames[:64], settings),
            ('dense 64x922x1228', dframes[:64], dsettings),
            ('640x480 16 frames', [other.frame(t)[:oh, :ow]
                                   for t in range(16)], settings)):
        labels, mask = compact_inputs(frs, sets, dev)
        bits = compact_bits(labels, mask)
        bench = bench or (labels, mask, sets, bits)
        md, mb = sets['max detections per frame'], \
            sets['max bounding box height']
        check_compact(name + ' (bytes)', labels, mask, md, mb)
        checks.append(check_compact(name, labels, mask, md, mb, timed=True,
                                    bits=bits))
    for case in cpc.CASES:
        mask, max_det, max_bh = cpc.compact_case(case)
        labels = torch.from_numpy(cpc.min_index_labels(mask)).to(dev)
        for bits in (None, torch.from_numpy(cpc.packed_mask(mask)).to(dev)):
            check_compact(case, labels, torch.from_numpy(mask).to(dev),
                          max_det, max_bh, bits=bits)
    log('compact edge cases {}: kernel bit-equal to the plain version with '
        'the mask and with it packed, one call each'.format(list(cpc.CASES)))
    # each kernel's resources at the bench batch
    labels, mask, sets, bits = bench
    lib = _build.load_kernels()
    for kernel, threads in (('roots_kernel', 256), ('tables_kernel', 256)):
        ptx = ptxas_of(lib.build_log, 'compact.cu', kernel)
        rec = {'kernel': kernel, 'source': 'compact.cu'}
        if ptx is not None:
            regs, spill, smem = ptx
            rec.update(registers=regs, spill_stores=spill, shared_bytes=smem,
                       occupancy_allowed=resident_share(regs, smem, threads))
        rec['achieved_occupancy_pct'] = achieved_occupancy(
            lambda: COMPACT(labels, mask,
                            max_det=sets['max detections per frame'],
                            max_bh=sets['max bounding box height'],
                            fg_bits=bits), kernel)
        log('compact resources ' + json.dumps(rec))
    return checks[0]


# ---- phase 33: run-CC around the propagations (csrc/run_cc.cu) ----

def run_cc_bytes(runs, row_tables, readback=None):
    """The bytes a run-CC call must move: the wire and counts in; run_comp
    and the three per-frame counts out, with the row tables those once
    (two int32 and a bool table of T max_det max_bh entries, min_y), with
    the readback plane the frames' validity in and the int16 plane
    out."""
    t, r = runs.shape
    extra = 0
    if row_tables:
        comps = t * row_tables['max_det']
        extra = 9 * comps * row_tables['max_bh'] + 4 * comps
    if readback:
        extra += t + 2 * t * (readback['runs'] + 2)
    return 4 * (t * r + t) + 4 * (t * r + 3 * t) + extra


def case_tables(h):
    """The row tables of the checks on small frames of height ``h``: 8
    rows, 1 row, and ids past max_det."""
    return [dict(h=h, max_det=64, max_bh=8), dict(h=h, max_det=64, max_bh=1),
            dict(h=h, max_det=3, max_bh=8)]


def case_readbacks(r, max_det=64):
    """The readback planes of the checks on a wire of R = ``r``: the
    host's width (``stage_detect``'s, at least 64 runs) at ``max_det``,
    every run at 3 detections (ids past max_det), one run."""
    return [dict(runs=min(r, 64), max_det=max_det),
            dict(runs=r, max_det=3), dict(runs=1, max_det=max_det)]


def host_readback_runs(rc, r):
    """``stage_detect``'s width of the readback plane: the next power of two
    of the batch's most runs, at least 64, at most R."""
    return min(r, max(64, 1 << max(int(rc.max()) - 1, 1).bit_length()))


def check_run_cc_steps(name, runs, rc, w, dev, tables, readbacks=None):
    """Each call of ``csrc/run_cc.cu``'s wrappers against its plain version
    on the same card tensors, every output bit-equal, one counted call
    each: prepare for both thresholds' dilations, with every frame valid
    and with the second invalid (the keys launch's counts), compact on
    the 4-connected labels, finish with and without the compaction, after
    the propagation and after one step of it, without and with each of
    ``tables``' row tables and of ``readbacks``' readback planes (the
    host-rect batch's int16 plane; ``case_readbacks`` by default), and
    ``run_cc_components`` through them, the plane with the second frame
    invalid."""
    wire = (torch.from_numpy(runs.view(np.int32)).to(dev),
            torch.from_numpy(rc).to(dev))
    t, r = runs.shape
    readbacks = readbacks or case_readbacks(r)
    fv = torch.ones(t, dtype=torch.bool, device=dev)
    fv[min(1, t - 1)] = False

    def same(got, want):
        if isinstance(want, dict):
            return all(same(got[k], want[k]) for k in want)
        if isinstance(want, (list, tuple)):
            return all(same(g, v) for g, v in zip(got, want))
        return want is None and got is None or (
            got.dtype == want.dtype and torch.equal(got, want))

    checks = []
    for dilates, weak, valid in (((0, 1), True, None), ((1,), False, None),
                                 ((0,), True, None), ((0, 1), True, fv),
                                 ((1,), False, fv)):
        n = run_cc.prepare_runs.launches
        got = run_cc.prepare_runs(*wire, w=w, dilates=dilates,
                                  weak_init=weak, frame_valid=valid)
        checks.append(run_cc.prepare_runs.launches == n + 1 and same(
            got, run_cc.prepare_runs_plain(*wire, w=w, dilates=dilates,
                                           weak_init=weak,
                                           frame_valid=valid)))
    g = run_cc.prepare_runs(*wire, w=w, dilates=(0, 1), weak_init=True)
    lab4, steps4 = propagate_min_fused(g['init'], g['wins'][0], g['link'])
    n = run_cc.compact_kept_runs.launches
    c = run_cc.compact_kept_runs(*wire, lab4, g['wins'][1], w=w)
    checks.append(run_cc.compact_kept_runs.launches == n + 1 and same(
        c, run_cc.compact_kept_runs_plain(*wire, lab4, g['wins'][1], w=w)))
    s1 = run_cc.prepare_runs(*wire, w=w, dilates=(1,))
    inputs = []
    for graph, c_orig, n_kept, st4 in (
            ((c['init'], c['win'], c['link']), c['c_orig'], c['n_kept'],
             steps4),
            ((s1['init'], s1['wins'][0], s1['link']), None, None, None)):
        lab, steps = propagate_min_fused(*graph)
        inputs.append((lab, c_orig, n_kept, st4, steps))
        # one step: labels that name no root
        lab, steps = run_cc.propagate_min(*graph, max_iters=1)
        inputs.append((lab, c_orig, n_kept, st4, steps))
    for args in inputs:
        for kw in [{}] + [dict(row_tables=tab) for tab in tables] + \
                [dict(readback=rb) for rb in readbacks]:
            n = run_cc.finish_components.launches
            n_rb = run_cc.finish_components.readback_launches
            got = run_cc.finish_components(*wire, *args, w=w, **kw)
            checks.append(run_cc.finish_components.launches == n + 1 and
                          run_cc.finish_components.readback_launches ==
                          n_rb + ('readback' in kw) and
                          same(got, run_cc.finish_components_plain(
                              *wire, *args, w=w, **kw)))
    for double in (True, False):
        for kw in [{}] + [dict(row_tables=tab) for tab in tables] + \
                [dict(readback=rb, frame_valid=fv) for rb in readbacks]:
            kw = dict(kw, w=w, double_threshold=double)
            checks.append(same(run_cc.run_cc_components(*wire, **kw),
                               run_cc.run_cc_components_plain(*wire, **kw)))
    torch.cuda.synchronize()
    if not all(checks):
        raise SystemExit('run-CC {}: a kernel differs from its plain '
                         'version (checks {})'.format(name, checks))
    return wire


def time_run_cc(name, wire, w, row_tables, readback=None):
    """``run_cc_components`` through the kernels against its plain
    version on the card (double threshold, with ``row_tables`` or, on the
    host-rect path, ``readback`` and the frames' validity where the path
    asks for them): event spans, the device time by kernel and the
    device span, the bound (the wire in and the outputs out once)."""
    kw = dict(w=w, double_threshold=True, row_tables=row_tables)
    if readback:
        kw.update(readback=readback, frame_valid=torch.ones(
            wire[0].shape[0], dtype=torch.bool, device=wire[0].device))

    def kernel(*_):
        out = run_cc.run_cc_components(*wire, **kw)
        return [out[k] for k in sorted(out)]

    def plain(*_):
        out = run_cc.run_cc_components_plain(*wire, **kw)
        return [out[k] for k in sorted(out)]

    check = check_equal('run_cc_components ' + name, kernel, plain, [], 0,
                        reps=20, plain_reps=5,
                        nbytes=run_cc_bytes(wire[0], row_tables, readback))
    per, span = device_ms(kernel)
    ops = device_ops(kernel)
    log('run-CC {}: device {:.4f} ms in {} operations ({}), event span '
        '{:.4f} ms vs plain {:.4f}, bound {:.4f} ms ({:.1f}% of the device '
        'time)'.format(name, sum(per.values()), ops,
                       json.dumps({k[:40]: round(v, 4)
                                   for k, v in per.items()}),
                       check[1], check[2], check[3][0],
                       100 * check[3][0] / max(sum(per.values()), 1e-9)))
    return check


def device_ops(fn):
    """Device operations a call of ``fn`` makes (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in prof.events())
        if ops:
            return ops
    return 0


def phase_run_cc(scene, settings, dscene, dsettings, dev):
    """Phase 33: run-CC's steps around the propagations
    (``csrc/run_cc.cu``: prepare, compact, finish with and without the
    row tables) against their plain versions on the card, bit for bit on
    every output: the bench and dense first batches (timed, the dense one
    with the dense path's row tables: event span, device time by kernel,
    the bound), phase 3's random graphs and the seeded cases of
    ``run_cc_cases.py`` (stale padding, a padded frame, a full table,
    edges, one row, no and all markers, one and two columns, runs of
    length 0 and out of raster order); each kernel's registers, spills
    and shared memory. Returns the dense batch's check."""
    checks = {}
    for name, sc, sets, dense in (
            ('bench', scene, settings, False),
            ('dense', dscene, dsettings, True)):
        runs, rc = first_batch_runs(sc, sets)
        max_det = sets['max detections per frame']
        tables = dict(h=H, max_det=max_det,
                      max_bh=sets['max bounding box height'])
        # the host-rect path's plane: stage_detect's width at the path's
        # capacity, then the edge cases
        plane = dict(runs=host_readback_runs(rc, runs.shape[1]),
                     max_det=max_det)
        wire = check_run_cc_steps(
            name, runs, rc, W, dev, [tables] + case_tables(H)[1:],
            [plane] + case_readbacks(runs.shape[1])[1:])
        checks[name] = time_run_cc('{} T={} R={}{}'.format(
            name, runs.shape[0], runs.shape[1],
            ' row tables' if dense else ' readback plane Rb={}'.format(
                plane['runs'])), wire, W,
            tables if dense else None, None if dense else plane)
    rng = np.random.default_rng(SEED)
    for t, h, w, r, dens in RANDOM_GRAPHS:
        runs, rc = random_runs(rng, t, h, w, r, dens)
        check_run_cc_steps('random {}x{}'.format(h, w), runs, rc, w, dev,
                           case_tables(h))
    for case in rcc_cases.CASES:
        runs, rc, w = rcc_cases.run_case(case)
        check_run_cc_steps(case, runs, rc, w, dev, case_tables(1 << 10))
    # a count above int16's range, max_det 8: the plane's count column
    # holds 32767
    runs, rc, w, h = rcc_cases.many_components()
    wire = check_run_cc_steps('many components', runs, rc, w, dev,
                              case_tables(h), [dict(runs=runs.shape[1],
                                                    max_det=8)])
    top = run_cc.run_cc_components(
        *wire, w=w, double_threshold=True,
        readback=dict(runs=runs.shape[1], max_det=8))['readback']
    if int(top[0, -2]) != 32767 or int((top[0, :-2] >= 0).sum()) != 8:
        raise SystemExit('run-CC: the readback plane of {} components '
                         'holds count {} and {} ids'.format(
                             rcc_cases.MANY_COMPONENTS, int(top[0, -2]),
                             int((top[0, :-2] >= 0).sum())))
    log('run-CC checks: bench, dense, random {}, cases {}, {} components '
        'a frame: every call bit-equal to its plain version, the row '
        'tables and the readback plane included (frame 1 invalid in the '
        'prepare and the plane\'s calls), one counted call each'.format(
            [g[:4] for g in RANDOM_GRAPHS], list(rcc_cases.CASES),
            rcc_cases.MANY_COMPONENTS))
    lib = _build.load_kernels()
    for kernel, threads in (('keys_kernel', 256), ('prepare_kernelILi2', 256),
                            ('prepare_kernelILi1', 256),
                            ('keep_kernel', 256), ('compact_kernel', 256),
                            ('roots_kernel', 256), ('ids_kernel', 256)):
        ptx = ptxas_of(lib.build_log, 'run_cc.cu', kernel)
        rec = {'kernel': kernel, 'source': 'run_cc.cu'}
        if ptx is not None:
            regs, spill, smem = ptx
            rec.update(registers=regs, spill_stores=spill, shared_bytes=smem,
                       occupancy_allowed=resident_share(regs, smem, threads))
        log('run-CC resources ' + json.dumps(rec))
    return checks['dense']


# ---- mean-threshold mode ----

MEAN = {'adaptive double threshold': -1.0}
#: the pixel wire's capacity in mean mode's pixels-mode runs: the bench
#: scene's mean threshold keeps about 11,300 pixels a frame, above the
#: bench's 8192, and a pixel the wire drops is a pixel frames mode keeps
MEAN_MAX_FG = {'max foreground pixels per frame': 16384}
#: mean mode's wrappers, looked up so that trace_kernels.py --root can load
#: this module over a checkout from before them (None there)
MEAN_PREPARE = getattr(pp, 'mean_prepare_from_bgr', None)
MEAN_MASKS = getattr(pp, 'mean_masks', None)
#: the torch passes the kernels replace on the card
MEAN_TORCH = (pp.bgr_to_gray, pp.blur3, pp.frame_mean_std_sums,
              pp.global_threshold)


def reset_mean_launches():
    reset_frames_launches()
    for k in (MEAN_PREPARE, MEAN_MASKS):
        k.launches = 0
    for k in MEAN_TORCH:
        k.cuda_calls = 0


def mean_launches(what):
    """Mean mode's frames path since ``reset_mean_launches``: raises unless
    the prepare and masks kernels ran once a detect batch (as often as the
    hull) and no torch gray, blur, sums or threshold pass ran on the card;
    returns the launches and counts."""
    launches = {k.__name__: k.launches for k in FRAMES_KERNELS +
                (MEAN_PREPARE, MEAN_MASKS)}
    torch_calls = {k.__name__: k.cuda_calls for k in MEAN_TORCH}
    idle = ('binary_reconstruct', 'adaptive_masks_from_bgr')
    if min(v for k, v in launches.items() if k not in idle) <= 0:
        raise SystemExit('{}: a kernel of the path was never launched: {}'
                         .format(what, launches))
    per = launches['hull_edge_vectors']
    if per <= 0 or (launches['mean_prepare_from_bgr'],
                    launches['mean_masks']) != (per, per):
        raise SystemExit('{}: {} prepare and {} masks launches for {} detect '
                         'batches'.format(what,
                                          launches['mean_prepare_from_bgr'],
                                          launches['mean_masks'], per))
    if any(torch_calls.values()) or any(launches[k] for k in idle):
        raise SystemExit('{}: torch passes on the card {}, adaptive masks '
                         'and reconstructions {}'.format(
                             what, torch_calls,
                             [launches[k] for k in idle]))
    points_gate(what)
    return {**launches, **{k + ' on cuda': v for k, v in torch_calls.items()}}


def check_mean_prepare(name, bgr, gray, timed=False):
    """The prepare kernel against its plain version on the card, bit-equal,
    one launch a call; with ``timed`` the ``check_equal`` record (the
    bound: the BGR read once, the blurred frames, the sums and with the
    gray the int32 gray written once; about 20 integer operations a pixel,
    counted at the float32 rate)."""
    n, h, w = bgr.shape[:3]
    if timed:
        return check_equal(
            'mean prepare ' + name,
            lambda *a: masks_outputs(MEAN_PREPARE(*a)),
            lambda *a: masks_outputs(pp.mean_prepare_from_bgr_plain(*a)),
            (bgr, gray), 20 * n * h * w, plain_reps=3,
            nbytes=n * h * w * (4 + 4 * gray) + 12 * n)
    before = MEAN_PREPARE.launches
    got = MEAN_PREPARE(bgr, gray)
    want = pp.mean_prepare_from_bgr_plain(bgr, gray)
    torch.cuda.synchronize()
    if MEAN_PREPARE.launches != before + 1 or any(
            (g is None) != (v is None) or
            (g is not None and not torch.equal(g, v))
            for g, v in zip(got, want)):
        raise SystemExit('mean prepare {} (gray {}): kernel != plain '
                         '(launches {})'.format(
                             name, gray, MEAN_PREPARE.launches - before))
    return got


def check_mean_masks(name, blurred, thr, valid, white, timed=False):
    """The masks kernel against its plain version on the card, bit-equal,
    one launch a call; with ``timed`` the ``check_equal`` record (the
    bound: the blurred frames read and the mask written once, the
    thresholds and frame_valid; two operations a pixel)."""
    args = (blurred, thr, valid, white)
    if timed:
        return check_equal('mean masks ' + name,
                           lambda *a: (MEAN_MASKS(*a),),
                           lambda *a: (pp.mean_masks_plain(*a),), args,
                           2 * blurred.numel(), plain_reps=3,
                           nbytes=2 * blurred.numel() + 5 * thr.numel())
    before = MEAN_MASKS.launches
    got = MEAN_MASKS(*args)
    want = pp.mean_masks_plain(*args)
    torch.cuda.synchronize()
    if MEAN_MASKS.launches != before + 1 or not torch.equal(got, want):
        raise SystemExit('mean masks {} (white {}): kernel != plain '
                         '(launches {})'.format(name, white,
                                                MEAN_MASKS.launches - before))
    return got


def host_thresholds(sums, valid, n_pix, white, offset=5):
    """The thresholds mean mode's detect sets from the sums: the 5 s
    moving average of each valid frame's mean + std + offset (white) or
    mean - std - offset (dark), 0 on padding frames."""
    state = pp.MovingAverageThreshold(FPS, offset if white else -offset,
                                      white)
    mean, std = pp.combine_mean_std(n_pix, *sums.cpu().numpy().T)
    thr = np.zeros(len(mean), np.int32)
    for i in np.flatnonzero(valid.cpu().numpy()):
        thr[i] = state.update(mean[i], std[i])
    return torch.from_numpy(thr).to(sums.device)


def phase_mean_mode(scene, settings, frames, dframes, dev):
    """Phase 34: mean-threshold mode. Both kernels of the mode
    (``csrc/adaptive_mean.cu``: ``ysmr_mean_prepare``, ``ysmr_mean_masks``)
    against their plain versions on the card, bit for bit: the bench and
    dense frames batches (timed, with and without the gray), a 16-frame
    640x480 batch, a short padded batch, the one-pixel-axis and uneven
    shapes of ``mean_mode_cases.py`` and its 1 x 40,000 frame of 255s,
    white and dark. Then the mode's paths on cuda: frames mode on the bench
    scene in memory, its ``_list.csv`` byte-identical to the pixels-mode
    device path's without cv2 centres (the gate: one prepare and one masks
    launch a detect batch, no torch gray, blur, sums or threshold pass on
    the card); the default pixels path (host threshold, run-CC, host rects,
    float64 tracker) on 16 frames, cuda byte-identical to cpu; frames mode
    with luminosity on 16 frames, cuda against cpu by ``compare_rows``.
    Returns the two kernels' bench checks and their launches on the
    frames path."""
    seed, _, (ow, oh) = MV_OTHER
    other = BenchScene(seed=seed)
    short = bgr_batch(frames[:40] + [np.zeros((H, W), np.uint8)] * 24, dev)
    batches = (('bench 64x922x1228', bgr_batch(frames[:64], dev)),
               ('dense 64x922x1228', bgr_batch(dframes[:64], dev)),
               ('640x480 16 frames', bgr_batch(
                   [other.frame(t)[:oh, :ow] for t in range(16)], dev)),
               ('short 40 of 64', short))
    checks = {}
    for name, bgr in batches:
        n = bgr.shape[0]
        valid = torch.arange(n, device=dev) < (40 if name.startswith('short')
                                               else n)
        timed = not name.startswith('short')
        for gray in (False, True):
            if timed:
                chk = check_mean_prepare(name, bgr, gray, timed=True)
                log('mean prepare {}{}: kernel {:.4f} ms, {:.1f}% of the '
                    'bound {:.4f} ms ({}); plain {:.4f} ms'.format(
                        name, ' with the gray' if gray else '', chk[1],
                        100 * chk[3][0] / chk[1], chk[3][0], chk[3][1],
                        chk[2]))
                checks.setdefault(('prepare', name), chk)
            out = check_mean_prepare(name, bgr, gray)
        blurred, sums = out[0], out[1]
        for white in (True, False):
            thr = host_thresholds(sums, valid, bgr.shape[1] * bgr.shape[2],
                                  white)
            if timed and white:
                chk = check_mean_masks(name, blurred, thr, valid, white,
                                       timed=True)
                log('mean masks {}: kernel {:.4f} ms, {:.1f}% of the bound '
                    '{:.4f} ms ({}); plain {:.4f} ms'.format(
                        name, chk[1], 100 * chk[3][0] / chk[1], chk[3][0],
                        chk[3][1], chk[2]))
                checks[('masks', name)] = chk
            check_mean_masks(name, blurred, thr, valid, white)
    rng = np.random.default_rng(SEED + 41)
    edges = [mmc.bgr_frames(rng, s) for s in mmc.SHAPES + mmc.EDGE_SHAPES]
    for bgr_np in edges + [mmc.wrap_frames()]:
        bgr = torch.from_numpy(bgr_np).to(dev)
        name = 'x'.join(map(str, bgr_np.shape[:3]))
        for gray in (False, True):
            out = check_mean_prepare(name, bgr, gray)
        n = bgr_np.shape[0]
        thr = torch.from_numpy(mmc.frame_thresholds(rng, n)).to(dev)
        for valid in (mmc.padded_valid(n), mmc.gapped_valid(n)):
            valid = torch.from_numpy(valid).to(dev)
            for white in (True, False):
                check_mean_masks(name, out[0], thr, valid, white)
    # the bench batch with padding frames between valid ones
    blurred = check_mean_prepare('bench', batches[0][1], False)[0]
    valid = torch.from_numpy(mmc.gapped_valid(blurred.shape[0])).to(dev)
    thr = torch.from_numpy(mmc.frame_thresholds(
        rng, blurred.shape[0])).to(dev)
    for white in (True, False):
        check_mean_masks('bench gapped', blurred, thr, valid, white)
    log('mean-mode kernels: bit-equal to their plain versions, one launch a '
        'call, on the four batches (white and dark, with and without the '
        'gray, a padded batch, the bench batch with padding between valid '
        'frames) and on {} and {} (padding at the end and between valid '
        'frames)'.format([e.shape[:3] for e in edges], mmc.WRAP_SHAPE))
    lib = _build.load_kernels()
    bgr = batches[0][1]
    blurred, sums, _ = MEAN_PREPARE(bgr)
    valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
    thr = host_thresholds(sums, valid, H * W, True)
    # the bench batch's instantiations: 4-byte words, 16-byte vectors
    for kernel, mangled, call, threads in (
            ('mean_prepare_kernel<true>', 'mean_prepare_kernelILb1E',
             lambda: MEAN_PREPARE(bgr), 128),
            ('global_threshold_kernel<true>',
             'global_threshold_kernelILb1E',
             lambda: MEAN_MASKS(blurred, thr, valid, True), 256)):
        ptx = ptxas_of(lib.build_log, 'adaptive_mean.cu', mangled)
        args = launch_args(call, kernel)
        rec = {'kernel': kernel, 'source': 'adaptive_mean.cu'}
        if ptx is not None:
            regs, spill, smem = ptx
            smem = int(args.get('shared memory') or smem)
            rec.update(registers=regs, spill_stores=spill, shared_bytes=smem,
                       occupancy_allowed=resident_share(regs, smem, threads))
        rec['achieved_occupancy_pct'] = args.get('est. achieved occupancy %')
        log('mean mode resources ' + json.dumps(rec))

    # the frames path against the pixels-mode device path
    fsettings = {**settings, **FRAMES, **MEAN}
    torch.cuda.synchronize()
    reset_mean_launches()
    t0 = time.perf_counter()
    res, fbytes, stats = run_loop(frames, fsettings, 'cuda', 'mean_frames')
    torch.cuda.synchronize()
    launches = mean_launches('mean-mode frames path')
    log('mean-mode frames path, bench scene in memory (cuda): rows {} tracks '
        '{} frames {} fps {:.2f} ({:.1f} s), launches {}; stage split '
        '(ms/frame): {}'.format(
            fbytes.count(b'\n') - 1, stats['tracks'], stats['frames'],
            stats['fps'], time.perf_counter() - t0, json.dumps(launches),
            per_frame(stats)))
    if not np.isfinite(res[0][['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all() or \
            stats['tracks'] <= 0:
        raise SystemExit('mean-mode frames path: no tracks or non-finite '
                         'values')
    pixels = {**settings, **MEAN, **MEAN_MAX_FG, 'cv2 exact rects': False,
              'cv2 exact centers': 'off'}
    overflow = WarningCounter('foreground pixels; extra pixels dropped')
    logging.getLogger('ysmr').addHandler(overflow)
    try:
        _, pbytes, pstats = run_loop(frames, pixels, 'cuda', 'mean_pixels')
        # the default pixels path (host threshold, run-CC, host rects,
        # float64 tracker), cuda against cpu
        reset_run_cc()
        cuda_vs_cpu('mean pixels', frames, {**settings, **MEAN, **MEAN_MAX_FG})
        run_cc_gate('mean pixels', run_cc_launches(), double=False)
    finally:
        logging.getLogger('ysmr').removeHandler(overflow)
    if overflow.count:
        raise SystemExit('mean mode: the pixel wire dropped foreground pixels '
                         '({} warnings)'.format(overflow.count))
    if fbytes != pbytes:
        raise SystemExit('mean mode: frames mode _list.csv differs from the '
                         'pixels-mode device path without cv2 centers')
    log('mean mode: frames _list.csv byte-identical to the pixels-mode '
        'device path without cv2 centers ({} rows; pixels fps {:.2f})'
        .format(fbytes.count(b'\n') - 1, pstats['fps']))
    # frames mode with luminosity, cuda against cpu
    lset = {**fsettings, **LUM, 'frame batch size': FRAMES_CPU_FRAMES}
    reset_mean_launches()
    cres, _, cstats = run_loop(frames[:FRAMES_CPU_FRAMES], lset, 'cuda',
                               'mean_lum_cuda')
    lum_launches = mean_launches('mean-mode frames path with luminosity')
    pres, _, _ = run_loop(frames[:FRAMES_CPU_FRAMES], lset, 'cpu',
                          'mean_lum_cpu')
    same, worst = compare_rows('mean-mode frames luminosity', cres[0],
                               pres[0])
    if not np.isfinite(cres[0]['ILLUMINATION'].to_numpy()).all():
        raise SystemExit('mean-mode frames luminosity: non-finite values')
    log('mean-mode frames luminosity cuda vs cpu on {} frames: {} rows, {} '
        'tracks, {} byte-identical rows, max |diff| {}; launches {}'.format(
            FRAMES_CPU_FRAMES, cres[0].shape[0], cstats['tracks'], same,
            json.dumps(worst), json.dumps(lum_launches)))
    return (checks[('prepare', batches[0][0])],
            checks[('masks', batches[0][0])], launches)


# ---- phase 35: the decode layer on the bench clip ----

#: phase 35's runs of the bench clip through track_bacteria(path): the
#: decode mode and 'host decode threads' (2, the default, stripes the
#: batches over two decode threads; 1 decodes on one thread; 0 inline)
DECODE_RUNS = (('exact, 2 threads', 'exact', 2),
               ('exact, 1 thread', 'exact', 1),
               ('exact, inline', 'exact', 0), ('fast, 2 threads', 'fast', 2))
#: the fast run's gates against the exact runs: tracks within this many,
#: rows within this share
FAST_TRACKS = 4
FAST_ROWS = 0.01


def avdec_state():
    """Whether the exact fused decode's module (``native/libysmr_avdec.so``)
    arms on this host, and what it found: the library's load, the ffmpeg
    libraries of cv2's wheel (``native._cv2_bundled_ffmpeg`` looks in
    ``opencv_python.libs``), the ``opencv*.libs`` folders beside cv2, and
    ``avdec_init``'s answer (1: an avcodec and swscale pair loaded)."""
    import ctypes
    import glob
    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    state = {'available': native.avdec_available(), 'cv2': cv2.__version__,
             'bundled_ffmpeg': [p and os.path.basename(p.decode())
                                for p in native._cv2_bundled_ffmpeg()],
             'libs_folders': {
                 os.path.basename(d): sorted(
                     os.path.basename(f) for f in glob.glob(os.path.join(
                         d, 'lib*')) if 'avcodec' in f or 'swscale' in f)
                 for d in glob.glob(os.path.join(site, 'opencv*.libs'))}}
    try:
        lib = ctypes.CDLL(os.path.join(REPO, 'native', 'libysmr_avdec.so'))
    except OSError as err:
        state['library'] = str(err)[:300]
        return state
    state['library'] = 'loads'
    lib.avdec_init.restype = ctypes.c_int
    lib.avdec_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.avdec_loaded_version.restype = ctypes.c_uint
    state['avdec_init'] = lib.avdec_init(*native._cv2_bundled_ffmpeg())
    state['avcodec_version'] = lib.avdec_loaded_version()
    return state


def decode_run(clip, settings, mode, threads, folder):
    """``track_bacteria(clip)`` on cuda in one decode mode: the reader it
    made (its stage-1 reader, not the probe), the loop's stats, the
    decoders' counts that moved, the list's bytes and the wall time."""
    import ysmr_tpu_torch.pipeline.track_bacteria as tbm
    readers, stats = [], {}

    class RecordingReader(tbm.BatchedVideoReader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            readers.append(self)

    def loop_with_stats(*args, **kwargs):
        return _track_loop(*args, **dict(kwargs, stats=stats))

    lut0, _ = native.avdec_gray_fast_stats()
    jdec0 = native.avdec_jdec_frames()
    os.makedirs(folder, exist_ok=True)
    saved = tbm.BatchedVideoReader, tbm._track_loop
    tbm.BatchedVideoReader, tbm._track_loop = RecordingReader, \
        loop_with_stats
    reset_run_cc()
    try:
        t0 = time.perf_counter()
        res = track_bacteria(clip, settings={
            **settings, 'decode mode': mode, 'host decode threads': threads},
            result_folder=folder)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tbm.BatchedVideoReader, tbm._track_loop = saved
    if res is None:
        raise SystemExit('decode {} x{}: track_bacteria returned None'
                         .format(mode, threads))
    what = 'decode {} x{}'.format(mode, threads)
    launches = run_cc_launches()
    run_cc_gate(what, launches)
    readback_gate(what, launches)
    lut1, status = native.avdec_gray_fast_stats()
    reader = readers[-1]
    with open(res[4], 'rb') as f:
        data = f.read()
    decoder = {'exact_fused': reader._exact_fused,
               'demuxer': reader._demux is not None,
               'n_stripes': reader._n_stripes, 'threaded': reader.threaded,
               'jdec_frames': native.avdec_jdec_frames() - jdec0,
               'lut_frames': lut1 - lut0, 'lut_status': status}
    return res, stats, decoder, data, wall


def phase_decode_modes(settings, smi):
    """Phase 35: the decode layer on the card. Phase 5's bench clip
    through ``track_bacteria(path)`` on cuda in each of ``DECODE_RUNS``,
    in turns (the four, then the four in reverse): which decoder served
    (the exact fused decode, the demuxer, the stripes, the first-party
    decoder's and the gray LUT's frames, whether the native library has
    the libjpeg stage-1 decode), rows, tracks, frames/s end to end and the
    loop's ``wait_batch`` ms/frame. Gates: every exact run row-identical
    to ``bench_data/bench_clip_list.csv.gz`` and its ``_list.csv``
    byte-identical to the other exact runs'; the striped run's stripes
    min(2, batches); the fast run's demuxer active, its tracks within
    ``FAST_TRACKS`` and rows within ``FAST_ROWS`` of the exact runs';
    run-CC's kernels and the readback plane once a batch in each run."""
    clip = os.path.join(WORK, 'bench_clip.avi')
    has_stage1 = hasattr(native._load(), 'decode_jpeg_gray_stage1')
    log('decode layer: avdec {}, the native library\'s libjpeg stage-1 '
        'decode {} ({})'.format(json.dumps(avdec_state()), has_stage1, smi))
    order = list(DECODE_RUNS) + list(DECODE_RUNS[::-1])
    exact_bytes, exact_rows, exact_tracks, summary = None, None, None, {}
    for i, (name, mode, threads) in enumerate(order):
        res, stats, decoder, data, wall = decode_run(
            clip, settings, mode, threads,
            os.path.join(WORK, 'decode_{}'.format(i)))
        df = res[0]
        rows, tracks = df.shape[0], int(df['TRACK_ID'].nunique())
        batches = -(-N_FRAMES // settings['frame batch size'])
        if mode == 'exact':
            hold_to_reference(name, df, 'bench_clip_list.csv.gz')
            if exact_bytes is None:
                exact_bytes, exact_rows, exact_tracks = data, rows, tracks
            elif data != exact_bytes:
                raise SystemExit('{}: _list.csv differs from the first exact '
                                 'run\'s'.format(name))
            if threads == 2 and decoder['n_stripes'] != min(2, batches):
                raise SystemExit('{}: {} stripes, not {}'.format(
                    name, decoder['n_stripes'], min(2, batches)))
        else:
            if not decoder['demuxer']:
                raise SystemExit('{}: the MJPG demuxer is not active'
                                 .format(name))
            if abs(tracks - exact_tracks) > FAST_TRACKS or \
                    abs(rows - exact_rows) > FAST_ROWS * exact_rows:
                raise SystemExit('{}: {} rows and {} tracks against the exact '
                                 'runs\' {} and {}'.format(
                                     name, rows, tracks, exact_rows,
                                     exact_tracks))
        wait = stats['stage_s']['wait_batch'] / stats['frames'] * 1e3
        fps = N_FRAMES / wall
        summary.setdefault(name, []).append((fps, wait))
        log('decode run {} ({}): decoder {}, libjpeg stage-1 {}; rows {} '
            'tracks {}; {:.2f} fps end to end (loop {:.2f}); wait_batch '
            '{:.4f} ms/frame; stage split (ms/frame) {}; {}'.format(
                i + 1, name, json.dumps(decoder), has_stage1, rows, tracks,
                fps, stats['fps'], wait, per_frame(stats), smi))
    log('decode modes in turns ({}): {}'.format(smi, json.dumps(
        {k: {'fps': [round(a, 2) for a, _ in v],
             'wait_batch_ms': [round(b, 4) for _, b in v]}
         for k, v in summary.items()})))


# ---- the luminosity paths' kernels: the rect mean and the pixel finish ----


def lum_wire(scene, settings, t=64):
    """The split pixel wire that luminosity takes (int16 x and y, uint8
    marker; zero past each frame's count) and the uint8 gray frames of the
    scene's first ``t`` frames, as the host threshold writes them; the
    pixel counts; whether the rule is the double threshold."""
    pre = HostPreprocessor({**settings, **LUM}, FPS,
                           max_fg=settings['max foreground pixels per frame'])
    wire = {k: [] for k in ('px_x', 'px_y', 'px_marker', 'gray')}
    counts = np.zeros(t, np.int32)
    for i in range(t):
        tab = pre(scene.frame(i))
        counts[i] = tab['count']
        for k, rows in wire.items():
            a = np.array(tab[k])
            if k != 'gray':
                a[counts[i]:] = 0
            rows.append(a)
    return ({k: np.stack(v) for k, v in wire.items()}, counts,
            pre.mode == 'adaptive_double')


def lum_detect_kw(wire, counts, double, settings, dev):
    """``detect_from_pixels``' keywords for a split wire on the card."""
    t = len(counts)
    return dict({k: torch.from_numpy(wire[k]).to(dev)
                 for k in ('px_x', 'px_y', 'px_marker')},
                frame_valid=torch.ones(t, dtype=torch.bool, device=dev),
                px_counts=torch.from_numpy(counts).to(dev), h=H, w=W,
                double_threshold=double,
                max_det=settings['max detections per frame'],
                max_bh=settings['max bounding box height'],
                cc_iters=MAX_ITERS)


def pixel_bucket(counts, f):
    """``stage_detect``'s width of the plane it copies: the next power of
    two above the largest count, at least 256, at most F."""
    return min(f, max(256, 1 << max(int(counts.max()) - 1, 1).bit_length()))


def host_rects(wire, counts, kw):
    """The host-rect path's rects of a batch: the detect's per-pixel
    indices read back and measured by the native cv2 recipe, as
    ``finish_detect`` measures them; (T, max_det, 5) float32 (0 where
    invalid) and (T, max_det) bool."""
    out = detect_from_pixels(**kw, return_det_px=True, skip_rect=True)
    fb = pixel_bucket(counts, wire['px_x'].shape[1])
    det = np.ascontiguousarray(out['det_px_idx'][:, :fb].cpu().numpy())
    packed = wire['px_y'][:, :fb].astype(np.uint32) * np.uint32(W) + \
        wire['px_x'][:, :fb].astype(np.uint32)
    rects, rvalid = native.cv2_rects_batch(np.ascontiguousarray(packed),
                                           counts, det, W, kw['max_det'])
    return np.where(rvalid[..., None], rects, np.float32(0)), rvalid


def captured_lum_call(fn):
    """The arguments (gray, cx, cy, w, h, angle, valid) and ``win`` of the
    first ``rect_mean_luminosity`` call inside ``fn()`` (not counted)."""
    from ysmr_tpu_torch.ops import luminosity as lum_ops
    real = lum_ops.rect_mean_luminosity
    seen = []

    @functools.wraps(real)
    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)
    lum_ops.rect_mean_luminosity = spy
    try:
        fn()
    finally:
        lum_ops.rect_mean_luminosity = real
    args, kwargs = seen[0]
    return args, kwargs.get('win', 48)


def lum_batches(dev):
    """The rect mean's inputs at the main path's shapes, as (name, args,
    win), args = (gray, cx, cy, w, h, angle, valid): the bench batch's
    host rects (uint8 gray, (64, 512) slots, the host-rect finish), the
    dense batch's device rects (uint8, (64, 4096)) and the frames-mode
    bench batch's device rects (int32 gray, (64, 512))."""
    out = []
    settings = bench_settings()
    wire, counts, double = lum_wire(BenchScene(), settings)
    kw = lum_detect_kw(wire, counts, double, settings, dev)
    rects, rvalid = host_rects(wire, counts, kw)
    r = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rects, -1, 0)))
    r = r.to(dev)
    out.append(('bench host rects', (torch.from_numpy(wire['gray']).to(dev),
                                     *r, torch.from_numpy(rvalid).to(dev)),
                settings.get('luminosity window size', 48)))
    dsettings = dense_settings()
    dwire, dcounts, ddouble = lum_wire(
        BenchScene(seed=DENSE_SEED, n_bugs=DENSE_BUGS), dsettings)
    dkw = lum_detect_kw(dwire, dcounts, ddouble, dsettings, dev)
    dgray = torch.from_numpy(dwire['gray']).to(dev)
    out.append(('dense device rects', *captured_lum_call(
        lambda: detect_from_pixels(**dkw, include_luminosity=True,
                                   gray_frames=dgray, lum_win=48,
                                   cv2_centers=True))))
    cfg = detect.DetectorConfig({**settings, **FRAMES, **LUM})
    scene = BenchScene()
    bgr = bgr_batch([scene.frame(i) for i in range(64)], dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    out.append(('frames-mode bench device rects', *captured_lum_call(
        lambda: detect.detect_batch(bgr, valid, cfg))))
    return out


def pixel_lists(kw):
    """The pixel-table branch's lists of a split wire as
    ``detect_from_pixels`` makes them: int32 x and y, the valid prefix
    (count and frame validity) and the marker."""
    px_x, px_y = kw['px_x'].to(torch.int32), kw['px_y'].to(torch.int32)
    f = px_x.shape[1]
    valid = (torch.arange(f, dtype=torch.int32, device=px_x.device)[None, :]
             < kw['px_counts'].to(torch.int32)[:, None]) & \
        kw['frame_valid'][:, None]
    return px_x, px_y, valid, kw['px_marker'].to(torch.int32) > 0


def finish_batches(dev):
    """The pixel finish's inputs at the main path's shapes, as (name,
    (lab_fg, keep, px_x, px_y, valid), keywords): the bench luminosity
    batch's host-rect plane (its ``stage_detect`` width) and the dense
    luminosity batch's row tables."""
    out = []
    for name, settings, scene, mode in (
            ('bench host-rect plane', bench_settings(), BenchScene(),
             'readback'),
            ('dense row tables', dense_settings(),
             BenchScene(seed=DENSE_SEED, n_bugs=DENSE_BUGS), 'row_tables')):
        wire, counts, double = lum_wire(scene, settings)
        kw = lum_detect_kw(wire, counts, double, settings, dev)
        px_x, px_y, valid, marker = pixel_lists(kw)
        lab_fg, keep = cc.cc_labels_at_pixels(
            px_x, px_y, valid, marker, h=H, w=W, double_threshold=double,
            max_iters=MAX_ITERS)
        mode_kw = dict(h=H, w=W)
        if mode == 'readback':
            mode_kw['readback'] = dict(f=pixel_bucket(counts, px_x.shape[1]),
                                       max_det=kw['max_det'])
        else:
            mode_kw['row_tables'] = dict(max_det=kw['max_det'],
                                         max_bh=kw['max_bh'])
        out.append((name, (lab_fg, keep, px_x, px_y, valid), mode_kw))
    return out


def finish_torch_passes(args, h, w, readback=None, row_tables=None):
    """The torch sequence the pixel finish replaces, on its inputs and
    with its keywords: the dense ids (``_compact_ids``), then the
    host-rect plane (``stage_detect``'s slice, casts and concatenation)
    or the row tables (``component_stats``' tables). Where the checkout
    has the finish's plain version, that; else the sequence as
    ``detect_pixels`` ran it."""
    if hasattr(cc, 'pixel_finish_plain'):
        return cc.pixel_finish_plain(*args, h=h, w=w, readback=readback,
                                     row_tables=row_tables)
    from ysmr_tpu_torch.pipeline import detect_pixels as dp
    lab_fg, keep, px_x, px_y, valid = args
    lin = torch.where(valid, px_y * w + px_x, torch.full_like(px_x, h * w))
    comp, n_comp = dp._compact_ids(lab_fg, keep, lin)
    out = {'n_components': n_comp}
    if readback is not None:
        det = torch.where(keep & (comp < readback['max_det']), comp,
                          torch.full_like(comp, -1)).to(torch.int16)
        out['readback'] = torch.cat(
            [det[:, :readback['f']],
             n_comp.clamp(max=32767)[:, None].to(torch.int16),
             torch.zeros_like(n_comp)[:, None].to(torch.int16)], dim=1)
    if row_tables is not None:
        max_det = row_tables['max_det']
        seg = torch.where(keep, torch.clamp(comp, max=max_det),
                          torch.full_like(comp, max_det))
        t, f = seg.shape
        frame = torch.arange(t, device=seg.device)[:, None].expand(t, f)
        rows = labeling._row_tables(
            frame.reshape(-1), px_x.reshape(-1), px_y.reshape(-1),
            seg.reshape(-1).long(), t, max_det=max_det,
            max_bh=row_tables['max_bh'])
        out.update(zip(('row_min_x', 'row_max_x', 'row_valid', 'min_y'),
                       rows))
    return out


def lum_gate(what, launches, batches, finish_batches):
    """The luminosity paths' two kernels were launched once a detect batch:
    the rect mean ``batches`` times (one a host-rect finish or device-rect
    detect), the pixel finish ``finish_batches`` times (one a pixel-table
    batch)."""
    want = {'rect_mean_luminosity': batches, 'pixel_finish': finish_batches}
    got = {k: launches[k] for k in want}
    if got != want:
        raise SystemExit('{}: launches {} of the luminosity kernels, not the '
                         '{} of one a batch'.format(what, got, want))


def n_batches(n_frames, settings):
    return -(-n_frames // settings['frame batch size'])


def rect_mean_bytes(args, win):
    """The bytes a rect-mean call's data needs: each member pixel's gray
    once, the slots' rect and flag in and their mean out."""
    from ysmr_tpu_torch.ops import luminosity as lum_ops
    members = int(lum_ops._window_sums(*args, win=win)[1].sum())
    slots = args[1].numel()
    return members * args[0].element_size() + slots * (5 * 4 + 1 + 4), \
        members


def finish_bytes(args, out):
    """The bytes a pixel-finish call moves: the lists (labels, x, y int32,
    keep and valid bytes) in once, its outputs out once."""
    return args[0].numel() * 14 + sum(v.numel() * v.element_size()
                                      for v in out.values())


#: one frame's list past the 25,165,824 slots the finish once took
PAST_CAP_F = 25_165_825


def phase_finish_past_cap(dev):
    """The pixel finish on one frame's list of ``PAST_CAP_F`` slots (8192
    pixels a row, every pixel its own root but a few components of several
    pixels: ``lum_cases.own_root_lists``), every output asked, bit-equal to
    its plain version on the card."""
    import lum_cases
    w = 8192
    h = -(-PAST_CAP_F // w)
    args = tuple(torch.from_numpy(a).to(dev) for a in
                 lum_cases.own_root_lists(1, PAST_CAP_F, h, w))
    kw = dict(h=h, w=w, ids=True,
              readback=dict(f=PAST_CAP_F, max_det=1024),
              row_tables=dict(max_det=64, max_bh=8))
    got = cc.pixel_finish(*args, **kw)
    want = cc.pixel_finish_plain(*args, **kw)
    torch.cuda.synchronize()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                        for k in want):
        raise SystemExit('pixel finish kernel != plain on one frame of {} '
                         'slots'.format(PAST_CAP_F))
    log('pixel finish kernel bit-equal to its plain version on one frame of '
        '{} slots ({} components; ids, plane and row tables)'.format(
            PAST_CAP_F, int(got['n_components'][0])))
    del args, got, want
    torch.cuda.empty_cache()


def phase_lum_kernels(dev):
    """Phase 36: the luminosity paths' kernels against their plain
    versions on the card. The rect mean (``csrc/luminosity.cu``) on the
    bench batch's host rects, the dense and the frames-mode batches' device
    rects and on ``lum_cases.py``'s edge cases; the pixel finish
    (``csrc/pixel_finish.cu``) on the bench and dense luminosity wires'
    labels (the host-rect plane, the row tables), on the edge cases in
    every combination of outputs and on one frame past the old cap
    (``phase_finish_past_cap``); ms, bound, registers and occupancy of each
    launch. Returns the (max_abs_err, ms, plain_ms, bound) checks of the
    dense batch's rect mean and the dense tables' finish."""
    import lum_cases
    from ysmr_tpu_torch.ops import luminosity as lum_ops
    t0 = time.perf_counter()
    checks = {}
    batches = lum_batches(dev)
    finishes = finish_batches(dev)
    for name, args, win in batches:
        nbytes, members = rect_mean_bytes(args, win)
        valid = int(args[6].sum())
        check = check_equal(
            'rect_mean_luminosity {} T={} D={} gray {} ({} valid, {} member '
            'pixels)'.format(name, *args[1].shape,
                             str(args[0].dtype).split('.')[-1], valid,
                             members),
            lambda *a: (lum_ops.rect_mean_luminosity(*a, win=win),),
            lambda *a: (lum_ops.rect_mean_luminosity_plain(*a, win=win),),
            args, ops=valid * 40, nbytes=nbytes, reps=20, plain_reps=3)
        checks['rect ' + name] = check
    for case in lum_cases.RECT_CASES:
        gray, params, valid, win = lum_cases.rect_case(case)
        args = [torch.from_numpy(gray).to(dev)] + \
            [torch.from_numpy(p).to(dev) for p in params] + \
            [torch.from_numpy(valid).to(dev)]
        if not torch.equal(lum_ops.rect_mean_luminosity(*args, win=win),
                           lum_ops.rect_mean_luminosity_plain(*args,
                                                              win=win)):
            raise SystemExit('rect mean kernel != plain on case ' + case)
    log('rect mean kernel bit-equal to its plain version on the {} edge '
        'cases of lum_cases.py'.format(len(lum_cases.RECT_CASES)))
    for name, fargs, kw in finishes:
        out = cc.pixel_finish(*fargs, **kw)
        check = check_equal(
            'pixel_finish {} T={} F={}'.format(name, *fargs[0].shape),
            lambda *a: tuple(cc.pixel_finish(*a, **kw).values()),
            lambda *a: tuple(cc.pixel_finish_plain(*a, **kw).values()),
            fargs, ops=fargs[0].numel(), nbytes=finish_bytes(fargs, out),
            reps=20, plain_reps=3)
        checks['finish ' + name] = check
    n_modes = 0
    for case in lum_cases.FINISH_CASES:
        c = lum_cases.finish_case(case)
        t = {k: torch.from_numpy(c[k]).to(dev)
             for k in ('px_x', 'px_y', 'valid', 'marker')}
        lab, keep = cc.cc_labels_at_pixels(
            t['px_x'], t['px_y'], t['valid'], t['marker'], h=c['h'],
            w=c['w'], double_threshold=c['double_threshold'])
        fargs = (lab, keep, t['px_x'], t['px_y'], t['valid'])
        plane = dict(f=c['plane_f'], max_det=c['max_det'])
        tables = dict(max_det=c['max_det'], max_bh=c['max_bh'])
        for mode in (dict(ids=True, readback=plane, row_tables=tables),
                     dict(readback=plane), dict(row_tables=tables), {}):
            got = cc.pixel_finish(*fargs, h=c['h'], w=c['w'], **mode)
            want = cc.pixel_finish_plain(*fargs, h=c['h'], w=c['w'], **mode)
            if set(got) != set(want) or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise SystemExit('pixel finish kernel != plain on case {} '
                                 '{}'.format(case, sorted(mode)))
            n_modes += 1
    log('pixel finish kernel bit-equal to its plain version on the {} edge '
        'cases of lum_cases.py ({} calls)'.format(
            len(lum_cases.FINISH_CASES), n_modes))
    phase_finish_past_cap(dev)
    lib = _build.load_kernels()
    resources = {}
    _, dense_args, dense_win = batches[1]
    dense_finish = finishes[1]
    finish_call = (lambda: cc.pixel_finish(*dense_finish[1],
                                           **dense_finish[2]))
    for source, kernel, threads, fn in (
            ('luminosity.cu', 'rect_mean_tiles', 256,
             lambda: lum_ops.rect_mean_luminosity(*dense_args,
                                                  win=dense_win)),
            ('pixel_finish.cu', 'finish_roots', 256, finish_call),
            ('pixel_finish.cu', 'finish_offsets', 32, finish_call),
            ('pixel_finish.cu', 'finish_ids', 256, finish_call)):
        ptx = ptxas_of(lib.build_log, source, kernel)
        regs, spill, smem = ptx if ptx else (None, None, None)
        resources[kernel] = {
            'registers': regs, 'spill_bytes': spill, 'smem_bytes': smem,
            'resident_share': None if regs is None else
            round(resident_share(regs, smem, threads), 4),
            'achieved_occupancy': achieved_occupancy(fn, kernel)}
    log('lum kernels resources {}'.format(json.dumps(resources)))
    log('phase 36 (the rect mean and the pixel finish) took {:.1f} s'.format(
        time.perf_counter() - t0))
    return checks['rect dense device rects'], checks['finish dense row tables']


def table_bytes(valid, double):
    """The bytes the table CC needs: the valid flags at every slot, the
    lin (and, with the double threshold, the marker) at the valid slots
    only, and the two outputs (int32 labels, bool keep) at every slot.
    Returns (bytes, valid slots)."""
    n_valid = int(valid.sum())
    return (valid.numel() * (1 + 4 + 1) + n_valid * (4 + int(bool(double))),
            n_valid)


def check_table(name, lin, valid, marker, h, w, double, lists=None):
    """The table kernel against its plain version, bit-equal on every frame
    where the plain labelings converged, on the sorted route and, where the
    valid entries are a raster prefix (``lists``, the pixel lists of the
    same table), on the raster-prefix route, the two routes bit-equal on
    every frame and equal to ``ysmr_cc_pixels`` where the frame is narrow
    enough for it; median ms of each and the bound. Returns (err, ms,
    plain_ms, bound, sorted_ms, pixels_ms)."""
    kw = dict(h=h, w=w, double_threshold=double, max_iters=MAX_ITERS)
    p_lab, p_keep, steps = cc.cc_labels_table_plain(lin, valid, marker, **kw)
    prefix = lists is not None
    got = {}
    for route in ((True, False) if prefix else (False,)):
        got[route] = cc.cc_labels_table(lin, valid, marker,
                                        raster_prefix=route, **kw)
    torch.cuda.synchronize()
    conv = steps < MAX_ITERS
    lab, keep = got[prefix]
    if not bool(conv.any()):
        raise SystemExit('{}: the plain version converged on no '
                         'frame'.format(name))
    for route, (g_lab, g_keep) in got.items():
        if not (torch.equal(g_lab[conv], p_lab[conv]) and
                torch.equal(g_keep[conv], p_keep[conv])):
            raise SystemExit('{}: table kernel != plain ({})'.format(
                name, 'raster prefix' if route else 'sorted'))
        if not (torch.equal(g_lab, lab) and torch.equal(g_keep, keep)):
            raise SystemExit('{}: the sorted and raster-prefix routes '
                             'differ'.format(name))
    pixels_ms = None
    if prefix and w <= cc.PIXEL_MAX_WIDTH:
        x_lab, x_keep = cc.cc_labels_at_pixels(*lists, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(x_lab, lab) and torch.equal(x_keep, keep)):
            raise SystemExit('{}: table kernel != ysmr_cc_pixels'.format(name))
        pixels_ms = cuda_ms(lambda: cc.cc_labels_at_pixels(*lists, **kw))
    err = max_abs_err((lab[conv], keep[conv]), (p_lab[conv], p_keep[conv]))
    ms = cuda_ms(lambda: cc.cc_labels_table(lin, valid, marker,
                                            raster_prefix=prefix, **kw))
    sorted_ms = cuda_ms(lambda: cc.cc_labels_table(lin, valid, marker, **kw))
    plain_ms = cuda_ms(lambda: cc.cc_labels_table_plain(lin, valid, marker,
                                                        **kw), reps=3)
    nbytes, n_valid = table_bytes(valid, double)
    bnd = bound((), (), pixel_ops(valid, w), nbytes)
    log('kernel check {}: T={} F={} w={} valid {} kept {}, bit-equal to '
        'plain on {} of {} frames (plain steps max {}){}; ms kernel {:.4f} '
        '({}) sorted {:.4f} plain {:.4f} ysmr_cc_pixels {} bound {:.4f} '
        '({}, {} bytes)'.format(
            name, lin.shape[0], lin.shape[1], w, n_valid, int(keep.sum()), int(conv.sum()), lin.shape[0], int(steps.max()),
            ', routes equal, equal to ysmr_cc_pixels' if pixels_ms else '',
            ms, 'raster prefix' if prefix else 'sorted', sorted_ms, plain_ms,
            'n/a' if pixels_ms is None else '{:.4f}'.format(pixels_ms),
            *bnd, nbytes))
    return err, ms, plain_ms, bnd, sorted_ms, pixels_ms


def shuffled_with_gaps(lin, valid, marker, seed):
    """The same tables at random slots of rows twice as long, in random
    order, the other slots invalid with stale lins."""
    t, f = lin.shape
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(2 * f, generator=g)[:f]
                        for _ in range(t)]).to(lin.device)
    out = (torch.full((t, 2 * f), 7, dtype=torch.int32, device=lin.device),
           torch.zeros((t, 2 * f), dtype=torch.bool, device=lin.device),
           torch.zeros((t, 2 * f), dtype=torch.bool, device=lin.device))
    for dst, src in zip(out, (lin, valid, marker)):
        dst.scatter_(1, perm, src)
    return out


#: the wide frames of phase 37: wider than ysmr_cc_pixels takes
WIDE_H, WIDE_W = 64, 50000


def wide_rod_lists(rng, t, dev):
    """Pixel lists of ``t`` frames of WIDE_H x WIDE_W with seeded rods
    (markers on a twentieth of their pixels)."""
    masks = np.zeros((t, WIDE_H, WIDE_W), np.uint8)
    for i in range(t):
        for _ in range(2000):
            cv2.ellipse(masks[i], (int(rng.integers(0, WIDE_W)),
                                   int(rng.integers(0, WIDE_H))),
                        (int(rng.integers(2, 12)), int(rng.integers(1, 4))),
                        float(rng.uniform(0, 180)), 0, 360, 1, -1)
    masks = masks > 0
    return lists_from_masks(masks, masks & (rng.random(masks.shape) < 0.05),
                            dev)


def table_run(frames, settings, extra, name):
    """The scene in memory on cuda with ``use table cc`` and ``extra``:
    (list bytes, stats, the launches by name of the pixel-table branch's
    kernels that phase 37 counts)."""
    kernels = (cc.cc_labels_table, cc.cc_labels_at_pixels,
               run_cc.expand_runs)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    _, got, stats = run_loop(frames, {**settings, 'use table cc': True,
                                      **extra}, 'cuda', name)
    torch.cuda.synchronize()
    return got, stats, {k.__name__: k.launches for k in kernels}


def expand_bytes(runs, rc, f):
    """The bytes the expansion needs: the run counts, the wire words below
    them (not the rest of the (T, R) bucket) and the two (T, F) outputs
    (int32 lin, bool marker). Returns (bytes, runs)."""
    t, r = runs.shape
    n_runs = int(np.clip(rc, 0, r).sum())
    return t * 4 + n_runs * 4 + t * f * (4 + 1), n_runs


def check_expand(name, runs, rc, f, double, dev):
    """The expansion kernel against its plain version on the card, every
    slot bit-equal (the slots past the pixels too); median ms of each and
    the bound."""
    args = (torch.from_numpy(runs.view(np.int32)).to(dev),
            torch.from_numpy(rc).to(dev))
    nbytes, n_runs = expand_bytes(runs, rc, f)
    log('{}: T={} R={} F={} runs {} ({} bytes for the bound)'.format(
        name, runs.shape[0], runs.shape[1], f, n_runs, nbytes))
    return check_equal(name, lambda *a: run_cc.expand_runs(*a, f, double),
                       lambda *a: run_cc.expand_runs_plain(*a, f, double),
                       args, 0, nbytes=nbytes)


def global_halo_tiles(lin, valid, w):
    """The tiles of the table CC whose window (the valid slots within two
    rows before the tile's first lin, and the tile's slots less than a row
    and a pixel past it) exceeds the slots its cross launch stages in
    shared memory, so that it reads them from global memory: (such tiles,
    tiles with a valid first slot), on the raster-prefix table."""
    lin, valid = (a.cpu().numpy() if torch.is_tensor(a) else a
                  for a in (lin, valid))
    n_global = n_tiles = 0
    tile = cc.TABLE_TILE
    for keys, ok in zip(lin, valid):
        for t0 in range(0, keys.shape[0], tile):
            if not ok[t0]:
                break
            lo = max(t0 - 2 * w, 0)
            ws = lo + int(np.searchsorted(keys[lo:t0], keys[t0] - 2 * w))
            hi = min(t0 + w + 1, t0 + tile, len(keys))
            cross = keys[t0:hi][ok[t0:hi]]
            te = t0 + int(np.searchsorted(cross, keys[t0] + w + 1))
            n_tiles += 1
            n_global += te - ws > cc.TABLE_WINDOW
    return n_global, n_tiles


def check_table_cases(dev):
    """The table kernel and the expansion against their plain versions on
    the edge cases of ``table_cc_cases.py`` at the kernels' tiling, bit
    for bit, one launch a call: the table's both thresholds on the raster
    prefix and sorted on the rows shuffled, the wire's both thresholds."""
    rng = np.random.default_rng(SEED + 38)
    for name in tcc_cases.TABLE_CASES:
        lin, valid, marker, h, w = tcc_cases.table_case(
            name, cc.TABLE_TILE, cc.TABLE_WINDOW)
        perm = np.stack([rng.permutation(lin.shape[1])
                         for _ in range(lin.shape[0])])
        routes = ((True, (lin, valid, marker)),
                  (False, tuple(np.take_along_axis(a, perm, 1)
                                for a in (lin, valid, marker))))
        for prefix, arrays in routes:
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            for double in (True, False):
                kw = dict(h=h, w=w, double_threshold=double,
                          max_iters=10 ** 4)
                want = cc.cc_labels_table_plain(*args, **kw)
                if not bool((want[2] < 10 ** 4).all()):
                    raise SystemExit('table case {}: the plain version did '
                                     'not converge'.format(name))
                cc.cc_labels_table.launches = 0
                got = cc.cc_labels_table(*args, raster_prefix=prefix, **kw)
                torch.cuda.synchronize()
                if cc.cc_labels_table.launches != 1 or not (
                        torch.equal(got[0], want[0]) and
                        torch.equal(got[1], want[1])):
                    raise SystemExit('table case {} ({}, {}): kernel != '
                                     'plain'.format(
                                         name, 'raster prefix' if prefix
                                         else 'sorted',
                                         'double' if double else 'single'))
        n_global, n_tiles = global_halo_tiles(*routes[0][1][:2], w)
        log('table case {}: {}x{} F={}, kernel bit-equal to plain (both '
            'thresholds, both routes); tiles with the window in global '
            'memory: {} of {}'.format(name, h, w, lin.shape[1], n_global,
                                      n_tiles))
    for name in tcc_cases.EXPAND_CASES:
        runs, rc, f = tcc_cases.expand_case(name, run_cc.EXPAND_TILE,
                                            run_cc.EXPAND_CHUNK)
        args = (torch.from_numpy(runs.view(np.int32)).to(dev),
                torch.from_numpy(rc).to(dev))
        for double in (True, False):
            want = run_cc.expand_runs_plain(*args, f, double)
            run_cc.expand_runs.launches = 0
            got = run_cc.expand_runs(*args, f, double)
            torch.cuda.synchronize()
            if run_cc.expand_runs.launches != 1 or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit('expand case {} F={}: kernel != '
                                 'plain'.format(name, f))
    log('expand cases: kernel bit-equal to plain on {} (both '
        'thresholds)'.format(', '.join(tcc_cases.EXPAND_CASES)))


def table_resources(table_call, expand_call):
    """ptxas' registers, spills and shared memory of each launch of the
    table CC and the expansion, the occupancy they allow and the
    profiler's achieved occupancy on the given calls (the dense batch)."""
    lib = _build.load_kernels()
    out = {}
    for source, ptx_name, prof_name, fn in (
            ('table_cc.cu', 'tcc_localILi4', 'tcc_local<4', table_call[0]),
            ('table_cc.cu', 'tcc_crossILi4', 'tcc_cross<4', table_call[0]),
            ('table_cc.cu', 'tcc_localILi8', 'tcc_local<8', table_call[1]),
            ('table_cc.cu', 'tcc_crossILi8', 'tcc_cross<8', table_call[1]),
            ('table_cc.cu', 'tcc_compress_mark', 'tcc_compress_mark',
             table_call[0]),
            ('table_cc.cu', 'tcc_diagonals', 'tcc_diagonals', table_call[0]),
            ('table_cc.cu', 'tcc_final', 'tcc_final', table_call[0]),
            ('expand_runs.cu', 'expand_sums', 'expand_sums', expand_call),
            ('expand_runs.cu', 'expand_tiles', 'expand_tiles',
             expand_call)):
        ptx = ptxas_of(lib.build_log, source, ptx_name)
        regs, spill, smem = ptx if ptx else (None, None, None)
        threads = 128 if 'cross' in prof_name else 256
        out[prof_name] = {
            'registers': regs, 'spill_bytes': spill, 'smem_bytes': smem,
            'resident_share': None if regs is None else
            round(resident_share(regs, smem, threads), 4),
            'achieved_occupancy': achieved_occupancy(fn, prof_name)}
    log('table cc resources {}'.format(json.dumps(out)))


def phase_table_cc(scene, settings, dscene, dsettings, frames, dframes,
                   run_bytes, dense_bytes, lum_bytes, dev):
    """Phase 37: ``use table cc``. The table kernel (``csrc/table_cc.cu``)
    against its plain version on the bench and dense tables (both
    thresholds, both routes), on the bench table shuffled among invalid
    slots, on frames wider than ``ysmr_cc_pixels`` takes and on the edge
    cases of ``table_cc_cases.py``; the expansion (``csrc/expand_runs.cu``)
    on the bench, dense and wide wires, the seeded wires and the edge
    cases; both kernels' resources; then the
    bench scene in memory with ``use table cc`` on the run wire (run-CC:
    no table launch), with 'run cc = off', with the pixel wire and with
    luminosity (a table launch a batch, no ``ysmr_cc_pixels``), and the
    dense scene with 'run cc = off', each list byte-identical to its
    counterpart without the flag. Returns (the bench table's check, the
    'run cc = off' run's launches)."""
    t0 = time.perf_counter()
    tables, packs = {}, {}
    for name, sc, st in (('bench', scene, settings),
                         ('dense', dscene, dsettings)):
        packs[name] = packed_batch(sc, st)
        lists = lists_from_packed(*packs[name], dev)
        tables[name] = ((lists[1] * W + lists[0]).contiguous(), lists[2],
                        lists[3], lists)
    main = check_table('table bench double', *tables['bench'][:3], H, W,
                       True, tables['bench'][3])
    check_table('table bench single', *tables['bench'][:3], H, W, False,
                tables['bench'][3])
    for double in (True, False):
        check_table('table dense {}'.format('double' if double else
                                            'single'),
                    *tables['dense'][:3], H, W, double, tables['dense'][3])
    check_table('table bench shuffled with gaps double',
                *shuffled_with_gaps(*tables['bench'][:3], SEED + 37), H, W,
                True)
    wide = wide_rod_lists(np.random.default_rng(SEED + 37), 2, dev)
    wlin = (wide[1] * WIDE_W + wide[0]).contiguous()
    for double in (True, False):
        check_table('table wide {}x{} {}'.format(
            WIDE_H, WIDE_W, 'double' if double else 'single'),
            wlin, wide[2], wide[3], WIDE_H, WIDE_W, double, wide)
    log('wide frames: tiles with the window in global memory: {} of '
        '{}'.format(*global_halo_tiles(wlin, wide[2], WIDE_W)))
    try:
        cc.cc_labels_at_pixels(*wide, h=WIDE_H, w=WIDE_W,
                               double_threshold=True)
    except ValueError as err:
        log('wide frames: ysmr_cc_pixels refuses them ({}); the table route '
            'runs'.format(err))
    else:
        raise SystemExit('wide frames: ysmr_cc_pixels did not refuse them')
    # the expansion of 'run cc = off' on the two batches' run wires, and
    # on the seeded wires at tables as wide as the pixels, wider and
    # narrower
    wires = {name: encode(*packed, W, None) + (packed[0].shape[1],)
             for name, packed in packs.items()}
    expand_main = check_expand('expand runs bench', *wires['bench'], True,
                               dev)
    check_expand('expand runs bench single', *wires['bench'], False, dev)
    check_expand('expand runs dense', *wires['dense'], True, dev)
    # the wide frames' run wire (chunks of runs and tiles of a wide row)
    ok = wide[2].cpu().numpy()
    wpacked = np.where(ok, wlin.cpu().numpy().astype(np.uint32) |
                       (wide[3].cpu().numpy().astype(np.uint32) << 31),
                       0).astype(np.uint32)
    for double in (True, False):
        check_expand('expand runs wide {}x{} {}'.format(
            WIDE_H, WIDE_W, 'double' if double else 'single'),
            *encode(wpacked, ok.sum(1).astype(np.int32), WIDE_W, None),
            wpacked.shape[1], double, dev)
    for case in rcc_cases.WIRE_CASES:
        runs, rc, _ = rcc_cases.run_case(case)
        total = max(int((runs[i, :rc[i]] >> 27).astype(np.int64).sum())
                    for i in range(len(rc)))
        for f in sorted({max(total, 1), total + 37, max(total // 2, 1)}):
            for double in (True, False):
                args = (torch.from_numpy(runs.view(np.int32)).to(dev),
                        torch.from_numpy(rc).to(dev))
                got = run_cc.expand_runs(*args, f, double)
                want = run_cc.expand_runs_plain(*args, f, double)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit('expand runs {} F={}: kernel != '
                                     'plain'.format(case, f))
    log('expand runs: kernel bit-equal to plain on the {} seeded wires, '
        'tables as wide as the pixels, wider and narrower, both '
        'thresholds'.format(len(rcc_cases.WIRE_CASES)))
    check_table_cases(dev)
    dlin, dvalid, dmarker = tables['dense'][:3]
    dwire = tuple(torch.from_numpy(a).to(dev) for a in
                  (wires['dense'][0].view(np.int32), wires['dense'][1]))
    table_resources(
        [functools.partial(cc.cc_labels_table, dlin, dvalid, dmarker, h=H,
                           w=W, double_threshold=double, raster_prefix=True)
         for double in (True, False)],
        lambda: run_cc.expand_runs(*dwire, wires['dense'][2], True))
    n_bench = n_batches(N_FRAMES, settings)
    off_launches = None
    for key, extra, want in (
            ('run wire', {}, run_bytes),
            ('run cc = off', {'run cc': 'off'}, run_bytes),
            ('pixel wire', {'wire format': 'pixels'}, run_bytes),
            ('luminosity', LUM, lum_bytes)):
        got, stats, launches = table_run(frames, settings, extra,
                                         'table_' + key.replace(' ', '_'))
        expect = {'cc_labels_table': 0 if key == 'run wire' else n_bench,
                  'cc_labels_at_pixels': 0,
                  'expand_runs': n_bench if key == 'run cc = off' else 0}
        if got != want:
            raise SystemExit('use table cc, {}: _list.csv differs from the '
                             'same run without it'.format(key))
        if launches != expect:
            raise SystemExit('use table cc, {}: launches {} (want '
                             '{})'.format(key, launches, expect))
        if key == 'run cc = off':
            off_launches = launches
        log('bench scene in memory with use table cc, {} (cuda): rows {} '
            'tracks {} fps {:.2f}, byte-identical to the run without it; '
            'launches {}; stage split (ms/frame): {}'.format(
                key, got.count(b'\n') - 1, stats['tracks'], stats['fps'],
                json.dumps(launches), per_frame(stats)))
    got, stats, launches = table_run(dframes, dsettings, {'run cc': 'off'},
                                     'table_dense')
    n_dense = n_batches(DENSE_FRAMES, dsettings)
    if got != dense_bytes:
        raise SystemExit("use table cc, dense 'run cc = off': _list.csv "
                         'differs from the dense device path')
    if launches != {'cc_labels_table': n_dense, 'cc_labels_at_pixels': 0,
                    'expand_runs': n_dense}:
        raise SystemExit("use table cc, dense 'run cc = off': launches "
                         '{}'.format(launches))
    log("dense scene in memory with use table cc, 'run cc = off' (cuda): "
        'rows {} tracks {} fps {:.2f}, byte-identical to the dense device '
        'path; launches {}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['tracks'], stats['fps'],
            json.dumps(launches), per_frame(stats)))
    log('phase 37 took {:.1f} s'.format(time.perf_counter() - t0))
    return main, expand_main, off_launches


def main():
    smi = phase_environment()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        dev = torch.device('cuda', 0)
        settings = bench_settings()
        scene = BenchScene()
        phase_build()
        dsettings = dense_settings()
        dscene = BenchScene(seed=DENSE_SEED, n_bugs=DENSE_BUGS)
        run_prop_check = phase_kernel(scene, settings, dscene, dsettings,
                                      dev)
        launches, frames, run_bytes = phase_main_path(scene, settings)
        phase_clip(settings)
        checks = phase_dense_kernels(dscene, dsettings, dev,
                                     frames_tables(scene, settings, dev))
        t0 = time.perf_counter()
        dframes = [dscene.frame(t) for t in range(DENSE_FRAMES)]
        log('dense scene: {} frames of {}x{}, {} rods, drawn in {:.1f} '
            's'.format(DENSE_FRAMES, W, H, DENSE_BUGS,
                       time.perf_counter() - t0))
        dense_launches, dense_bytes = phase_dense_path(dscene, dframes,
                                                       dsettings)
        phase_dense_cuda_vs_cpu(dframes, dsettings)
        cc_checks = phase_cc_kernels(scene, settings, dev)
        frames_runs = phase_frames_path(frames, settings, dframes, dsettings)
        phase_frames_cuda_vs_cpu(frames, settings)
        pixel_check = phase_pixel_kernel(scene, settings, dscene, dsettings,
                                         dev)
        phase_pixel_wires(frames, settings, run_bytes)
        lum_launches, lum_bytes = phase_lum_bench(frames, settings)
        phase_lum_dense(dscene, dframes, dsettings, dense_bytes, dev)
        phase_lum_frames(frames, settings)
        phase_dense_exact(dframes, dsettings)
        phase_program(settings)
        phase_display(settings)
        phase_compact(dframes, dsettings)
        phase_det_px(scene, settings, dev)
        phase_pool(settings)
        mv_lists = phase_multi_video(settings)
        phase_program_sharded(mv_lists)
        phase_sharded_assign(dframes, dsettings, dev)
        phase_keep_and_entry(scene, settings, dev)
        phase_batched_tracker(dframes, dsettings, dev)
        (mean_check, mean_conv_ms), masks_check = \
            phase_adaptive_mean(scene, settings, dscene, dev)
        gsff_check = phase_gsff(dframes, dsettings, settings, dev)
        step_check = phase_frame_step(dframes, dsettings, dev)
        tail_checks = phase_rect_tail(scene, settings, dscene, dsettings,
                                      dframes, dev)
        compact_check = phase_compaction(frames, settings, dframes,
                                         dsettings, dev)
        run_cc_check = phase_run_cc(scene, settings, dscene, dsettings, dev)
        mean_prepare_check, mean_masks_check, mean_runs = phase_mean_mode(
            scene, settings, frames, dframes, dev)
        phase_decode_modes(settings, smi)
        lum_check, finish_check = phase_lum_kernels(dev)
        table_check, expand_check, table_launches = phase_table_cc(
            scene, settings, dscene, dsettings, frames, dframes, run_bytes,
            dense_bytes, lum_bytes, dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    records = [kernel_record(
        'propagate_min_fused', 'ysmr_tpu_torch/csrc/run_prop.cu',
        'ysmr_tpu/ops/pallas_run_prop.py:189',
        launches['propagate_min_fused'], run_prop_check)]
    for name, src, rep in (
            ('hull_edge_vectors', 'hull.cu', 'pallas_hull.py:107'),
            ('sweep_extents', 'sweep.cu', 'pallas_sweep.py:63'),
            ('row_min_argmin', 'assign.cu', 'pallas_assign.py:100')):
        key = name.split('_')[0] if name != 'row_min_argmin' else 'assign'
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/' + src, 'ysmr_tpu/ops/' + rep,
            dense_launches[name], checks[key]))
    for name, line in (('label_components_whole_frame', 229),
                       ('binary_reconstruct', 295)):
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/cc.cu',
            'ysmr_tpu/ops/pallas_cc.py:{}'.format(line),
            frames_runs['bench'][name], cc_checks[name]))
    records.append(kernel_record(
        'cc_labels_at_pixels', 'ysmr_tpu_torch/csrc/cc.cu',
        'ysmr_tpu/ops/pallas_cc.py:347',
        lum_launches['cc_labels_at_pixels'], pixel_check))
    # the int32 entry is off the main path since the fused preprocess: its
    # count is the frames path's (0, gated so in phase 10); phase 28 drives
    # detect_from_blurred to check it
    records.append(kernel_record(
        'adaptive_gaussian_mean', 'ysmr_tpu_torch/csrc/adaptive_mean.cu',
        'ysmr_tpu/ops/preprocess.py:69',
        frames_runs['bench']['adaptive_gaussian_mean'], mean_check,
        library_ms=mean_conv_ms))
    records.append(kernel_record(
        'adaptive_masks_from_bgr', 'ysmr_tpu_torch/csrc/adaptive_mean.cu',
        'ysmr_tpu/pipeline/detect.py:43 prepare_batch, '
        'ysmr_tpu/ops/preprocess.py:185 detect_masks and & frame_valid '
        '(plain XLA)', frames_runs['bench']['adaptive_masks_from_bgr'],
        masks_check))
    records.append(kernel_record(
        'gsff_step', 'ysmr_tpu_torch/csrc/gsff.cu',
        'ysmr_tpu/ops/gsff.py:190 _step (plain XLA)',
        dense_launches['register_and_step'], gsff_check))
    records.append(kernel_record(
        'match_and_register', 'ysmr_tpu_torch/csrc/frame_step.cu',
        'ysmr_tpu/pipeline/tracker.py:129 _tracker_frame_update (plain XLA)',
        dense_launches['match_and_register'], step_check))
    for name, src, rep in (
            ('cv2_centers_from_tables', 'cv2_centers.cu',
             'ysmr_tpu/ops/cv2_centers.py:157 cv2_centers_from_tables '
             '(plain XLA)'),
            ('edge_finish', 'rect.cu',
             'ysmr_tpu/ops/labeling.py:736 _edge_vector_finish (plain XLA)'),
            ('rect_select', 'rect.cu',
             'ysmr_tpu/ops/labeling.py:877 _min_area_rect_exact after the '
             'sweep (plain XLA)')):
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/' + src, rep, dense_launches[name],
            tail_checks[name]))
    records.append(kernel_record(
        'compact_row_tables', 'ysmr_tpu_torch/csrc/compact.cu',
        'ysmr_tpu/ops/labeling.py:211 compact_labels, :588 '
        'component_tables (plain XLA)',
        frames_runs['bench']['compact_row_tables'], compact_check))
    # the main path's launches of csrc/run_cc.cu (prepare, compact and
    # finish each once a batch); the times are the dense batch's call,
    # with the row tables
    records.append(kernel_record(
        'run_cc_components', 'ysmr_tpu_torch/csrc/run_cc.cu',
        'ysmr_tpu/ops/run_cc.py:291 run_cc_components outside '
        'propagate_min, and the row tables of ysmr_tpu/ops/labeling.py:520 '
        'component_stats_runs (plain XLA)',
        sum(launches[k] for k in RUN_CC_NAMES), run_cc_check))
    # the mean-mode kernels' launches on their path (phase 34's frames run:
    # one each a detect batch); the times are the bench batch's
    records.append(kernel_record(
        'mean_prepare_from_bgr', 'ysmr_tpu_torch/csrc/adaptive_mean.cu',
        'ysmr_tpu/pipeline/detect.py:40 prepare_batch(needs_sums=True): '
        'bgr_to_gray, blur3, frame_mean_std_sums (plain XLA)',
        mean_runs['mean_prepare_from_bgr'], mean_prepare_check))
    records.append(kernel_record(
        'mean_masks', 'ysmr_tpu_torch/csrc/adaptive_mean.cu',
        'ysmr_tpu/ops/preprocess.py:105 global_threshold and & frame_valid '
        '(plain XLA)', mean_runs['mean_masks'], mean_masks_check))
    # the luminosity paths' kernels on the bench clip with luminosity and
    # GSFF (phase 14: one each a batch); the times are phase 36's dense
    # batch's
    records.append(kernel_record(
        'rect_mean_luminosity', 'ysmr_tpu_torch/csrc/luminosity.cu',
        'ysmr_tpu/ops/luminosity.py:113 rect_mean_luminosity (plain XLA)',
        lum_launches['rect_mean_luminosity'], lum_check))
    records.append(kernel_record(
        'pixel_finish', 'ysmr_tpu_torch/csrc/pixel_finish.cu',
        'ysmr_tpu/pipeline/detect_pixels.py:273 compact_ids and the row '
        'tables of ysmr_tpu/ops/labeling.py:381 component_stats (plain XLA)',
        lum_launches['pixel_finish'], finish_check))
    # use table cc's kernel on its path ('run cc = off' on the bench
    # scene, phase 37: one a batch); the times are the bench table's
    records.append(kernel_record(
        'label_components_table', 'ysmr_tpu_torch/csrc/table_cc.cu',
        'ysmr_tpu/ops/labeling.py:108 label_components_table (plain XLA), '
        'with :180 compact_labels_table and the marker segment max of '
        'ysmr_tpu/pipeline/detect_pixels.py:300-323',
        table_launches['cc_labels_table'], table_check))
    records.append(kernel_record(
        'expand_runs', 'ysmr_tpu_torch/csrc/expand_runs.cu',
        'ysmr_tpu/pipeline/detect_pixels.py:149-198 the run wire expanded '
        'to the pixel table and _marker_from_runs (plain XLA)',
        table_launches['expand_runs'], expand_check))
    print(json.dumps({'kernels': records}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
