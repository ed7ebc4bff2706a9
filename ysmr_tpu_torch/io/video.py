# Copied from ysmr_tpu/io/video.py; the import lines differ, and comments
# that quoted timings of the TPU round or described the JAX package.
#!/usr/bin/env python3
"""Host video decode feeding device-resident frame batches.

The reference reads one frame at a time inside its Python hot loop
(track_eval.py:156-366, ``cap.read()`` per iteration). Here decode runs on a
background thread producing fixed-size frame batches through a bounded queue,
so host decode overlaps device compute (double/triple buffering). Whether
the device still waits on the decoder depends on the clip and the host
(the ``wait_batch`` stage time says; PERF.md §5).

Decoding itself uses OpenCV's C++ videoio (FFmpeg underneath) — the same
native decode path as the reference — but batched and threaded. cv2 releases
the GIL inside ``cap.read``, so a Python thread is a true overlap.
"""

import logging
import queue
import threading

import cv2
import numpy as np


class VideoReadError(RuntimeError):
    pass


class MjpgAviDemuxer:
    """Raw JPEG frame chunks from an MJPG-in-AVI file (RIFF scan).

    The default decode path (cv2.VideoCapture, FFmpeg) decodes every JPEG to
    full-resolution BGR and then the pipeline reduces it to grayscale. For
    the default grayscale color filter that round trip is wasted work: JPEG
    luma IS the grayscale channel. Demuxing the AVI ourselves and handing
    each JPEG to ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` lets libjpeg skip
    the chroma IDCTs and the YCbCr->BGR->gray conversions entirely (the
    saving is not measured on the H100 machine).

    Gray values differ from the exact BGR-roundtrip recipe by at most +-2
    (systematic +-1 from the dropped double rounding); the adaptive
    threshold modes compare src against a local mean of the same data, so
    the shared bias cancels and detections are unchanged in practice. The
    'exact' decode mode remains the default for bit-parity work.
    """

    def __init__(self, path):
        import mmap
        self.path = path
        self._file = open(path, 'rb')
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        if mm[0:4] != b'RIFF' or mm[8:12] != b'AVI ':
            raise VideoReadError('Not an AVI file: {}'.format(path))
        movi = mm.find(b'movi')
        if movi < 0:
            raise VideoReadError('No movi list in {}'.format(path))
        self.offsets = []  # (start, size) of each JPEG chunk
        pos = movi + 4
        end = len(mm)
        while pos + 8 <= end:
            ckid = mm[pos:pos + 4]
            if ckid == b'idx1':
                break
            size = int.from_bytes(mm[pos + 4:pos + 8], 'little')
            if pos + 8 + size > end:
                break  # truncated chunk
            # stream 00 (the first/video stream) only: a second stream's
            # 'NNdc'/'NNdb' chunks would otherwise misalign frame indices
            if ckid[:2] == b'00' and ckid[2:4] in (b'dc', b'db') and size > 0:
                self.offsets.append((pos + 8, size))
            pos += 8 + size + (size & 1)

    def __len__(self):
        return len(self.offsets)

    def chunk(self, index):
        """Raw JPEG bytes of frame ``index`` (zero-copy mmap view)."""
        start, size = self.offsets[index]
        return np.frombuffer(self._mm, np.uint8, count=size, offset=start)

    def read_gray(self, index):
        """Decode frame ``index`` directly to grayscale (H, W) uint8."""
        return cv2.imdecode(self.chunk(index), cv2.IMREAD_GRAYSCALE)

    def close(self):
        try:
            self._mm.close()
            self._file.close()
        except Exception:
            pass


class BatchedVideoReader:
    """Iterate fixed-size (padded) frame batches from a video file.

    Yields dicts with ``frames`` (B, H, W, 3) uint8 BGR, ``start`` (global
    index of first frame), and ``count`` (valid frames in this batch; the
    remainder is zero-padded). The final short batch is padded so every
    device step sees identical shapes (no recompilation).
    """

    def __init__(self, video_path, batch_size=16, prefetch=3, color_filter=None,
                 preprocess=None, decode_mode='exact', decode_threads=1,
                 threaded=True):
        self.logger = logging.getLogger('ysmr').getChild(__name__)
        self.path = video_path
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.color_filter = color_filter
        self.preprocess = preprocess
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise VideoReadError('Cannot open file {}'.format(video_path))
        self.frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = cap.get(cv2.CAP_PROP_FPS)
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC)) & 0xFFFFFFFF
        fourcc = fourcc.to_bytes(4, 'little')
        self._fourcc = fourcc
        self._demux = None
        self._exact_fused = False
        # the fused demux paths apply only on the preprocessed (grayscale)
        # pipeline: the frames path ships BGR to the device, so there is
        # nothing to skip. 'fast' trades bit-parity for the gray-only
        # libjpeg decode; 'exact' runs the SAME libraries as cv2's videoio
        # (libavcodec MJPEG + libswscale) directly on the demuxed chunks,
        # guarded by a first-frame byte-compare against cap.read() below.
        want_fast = decode_mode == 'fast'
        want_exact_fused = (
            decode_mode == 'exact' and preprocess is not None and
            getattr(preprocess, 'supports_exact_fused', lambda: False)())
        if (want_fast or want_exact_fused) and preprocess is not None and \
                (color_filter is None or color_filter == cv2.COLOR_BGR2GRAY) \
                and fourcc in (b'MJPG', b'mjpg'):
            try:
                demux = MjpgAviDemuxer(video_path)
                if len(demux) >= self.frame_count > 0 or self.frame_count <= 0:
                    self._demux = demux
                    if self.frame_count <= 0:
                        self.frame_count = len(demux)
                else:
                    demux.close()
            except (VideoReadError, OSError, ValueError) as err:
                self.logger.debug('MJPG demux unavailable for %s (%s); '
                                  'using cv2 decode.', video_path, err)
        if self._demux is not None and want_exact_fused:
            # first-frame parity self-check: the system libavcodec/libswscale
            # must reproduce cv2's bundled ones byte-for-byte (IDCT and
            # yuv->bgr arithmetic can differ across ffmpeg versions). One
            # mismatching byte falls the whole file back to cap.read().
            from ysmr_tpu_torch import native as _native
            ok, first = cap.read()
            bgr = _native.avdec_decode_bgr(self._demux.chunk(0)) \
                if ok and len(self._demux) else None
            # the gray check runs the actual per-frame conversion, which
            # includes the proven gray-content LUT fast path when it arms
            # (native/avdec.cpp); its reference is the exact cv2 recipe on
            # the cap.read() frame
            gray = _native.avdec_decode_gray(self._demux.chunk(0)) \
                if bgr is not None else None
            gray_ok = gray is not None and bool(np.array_equal(
                gray,
                ((first[:, :, 0].astype(np.int32) * 3735 +
                  first[:, :, 1].astype(np.int32) * 19235 +
                  first[:, :, 2].astype(np.int32) * 9798 +
                  (1 << 14)) >> 15).astype(np.uint8)))
            if bgr is not None and gray_ok and bgr.shape == first.shape and \
                    np.array_equal(bgr, first):
                self._exact_fused = True
                self.logger.debug('Exact libav fused decode active for %s',
                                  video_path)
            else:
                self._demux.close()
                self._demux = None
                self.logger.debug(
                    'Exact libav decode self-check failed for %s; '
                    'using cv2 decode.', video_path)
                cap.release()
                cap = cv2.VideoCapture(video_path)  # frame 0 was consumed
        if self._demux is not None:
            cap.release()
            if not self._exact_fused:
                self.logger.debug('Fast MJPG grayscale decode active for %s',
                                  video_path)
        self._cap = cap
        self._queue = queue.Queue(maxsize=prefetch)
        self._thread = None
        self.frames_read = 0
        self.error_during_read = False
        self.read_stopped_early = False
        # threaded=False decodes inline in the consumer: on a single-core
        # host a decode thread buys no parallelism (the GIL and the core are
        # both contended) and costs context switches; device work still
        # overlaps because dispatch is asynchronous either way
        self.threaded = threaded
        self._n_stripes = self._resolve_stripes(decode_threads)

    def _resolve_stripes(self, decode_threads):
        """Number of parallel decode workers (1 = the sequential path).

        Striped decode interleaves whole batches over worker threads, each
        with its own capture/demux handle. It requires random access with
        exact sequential semantics, so it is gated to:
        - a known frame count (partitioning needs a bound),
        - MJPG input (intra-only; cv2 frame seeks land exactly — verified by
          the byte-identical striped-vs-sequential test) or an active demuxer,
        - threshold modes without cross-frame state (the mean mode's moving
          average consumes frames strictly in order).
        """
        threads = int(decode_threads or 1)
        if threads <= 1:
            return 1
        if self.frame_count <= 0:
            self.logger.debug('Striped decode off: unknown frame count.')
            return 1
        if self.preprocess is not None and \
                getattr(self.preprocess, 'threshold_state', None) is not None:
            self.logger.debug('Striped decode off: mean-threshold mode is '
                              'sequential.')
            return 1
        if self._demux is None and self._fourcc not in (b'MJPG', b'mjpg'):
            self.logger.debug('Striped decode off: non-MJPG input (frame '
                              'seeks are not exact on inter-frame codecs).')
            return 1
        n_batches = -(-self.frame_count // self.batch_size)
        return max(1, min(threads, n_batches))

    def _stack_batch(self, batch):
        if self.preprocess is None:
            if len(batch) == self.batch_size:
                return np.stack(batch)
            arr = np.zeros((self.batch_size,) + batch[0].shape, np.uint8)
            arr[:len(batch)] = np.stack(batch)
            return arr
        # preprocessed pixel tables: stack each field, zero-pad short batches
        keys = batch[0].keys()
        out = {}
        for key in keys:
            if key == 'count':
                counts = np.zeros(self.batch_size, np.int32)
                counts[:len(batch)] = [b['count'] for b in batch]
                out['count'] = counts
            else:
                first = batch[0][key]
                arr = np.zeros((self.batch_size,) + first.shape, first.dtype)
                for i, b in enumerate(batch):
                    arr[i] = b[key]
                out[key] = arr
        return out

    def _decode_chunk_frame(self, idx):
        """Per-frame fallback decode of demux chunk ``idx`` matching the
        active mode's arithmetic: exact mode must keep the cap.read()
        recipe (avdec full-BGR decode), fast mode uses libjpeg grayscale."""
        if self._exact_fused:
            from ysmr_tpu_torch import native as _native
            return _native.avdec_decode_bgr(self._demux.chunk(idx))
        return self._demux.read_gray(idx)

    def _read_buffer(self):
        """Reusable cap.read() destination, or None when unsafe.

        Passing a preallocated Mat skips cv2's per-frame allocation+copy
        (not measured on the H100 machine). Only valid when the frame is
        consumed before the next read: the preprocessor reduces it to pixel tables
        immediately, but keep_frames (display) retains the object and the
        frames path batches raw frames, so both keep the allocating read.
        """
        if self.preprocess is None or \
                getattr(self.preprocess, 'keep_frames', False):
            return None
        return np.empty((self.height, self.width, 3), np.uint8)

    def _prep_frame(self, frame):
        """Per-frame host work shared by the sequential and striped paths."""
        if self.preprocess is None:
            if self.color_filter is not None and \
                    self.color_filter != cv2.COLOR_BGR2GRAY and frame.ndim == 3:
                # non-default colour filters convert on host (rare path);
                # result is re-expanded so the device sees one layout
                gray = cv2.cvtColor(frame, self.color_filter)
                if gray.ndim == 2:
                    frame = np.repeat(gray[..., None], 3, axis=2)
            return frame
        return self.preprocess(frame)

    def _decode_batches(self):
        """Generator of (payload, start, count) — the single decode flow
        shared by the threaded and inline iterators. Updates
        ``frames_read`` as it goes; raises VideoReadError on decode errors;
        always releases the capture/demux handle."""
        cap = self._cap
        batch = []
        start = 0
        idx = 0
        # fused native decode+preprocess: the decoder writes gray straight
        # into the C++ preprocessing buffers (no intermediate image object).
        # fast mode: libjpeg gray-only; exact mode: libavcodec + libswscale
        # (cap.read()-byte-identical, verified by the open-time self-check).
        fused_fn = None
        if self._demux is not None and self.preprocess is not None:
            fused_fn = getattr(
                self.preprocess,
                'process_jpeg_exact' if self._exact_fused else 'process_jpeg',
                None)
        read_buf = self._read_buffer() if self._demux is None else None
        try:
            while True:
                self.frames_read = idx
                if self._demux is not None:
                    if idx >= len(self._demux):
                        break
                    if fused_fn is not None:
                        entry = fused_fn(self._demux.chunk(idx))
                        if entry is not None:
                            batch.append(entry)
                            idx += 1
                            if len(batch) == self.batch_size:
                                yield self._stack_batch(batch), start, \
                                    len(batch)
                                batch = []
                                start = idx
                            continue
                        # native decode unavailable for this frame: fall
                        # through to the matching per-frame decoder
                    frame = self._decode_chunk_frame(idx)
                    if frame is None:
                        # a mid-stream chunk that fails to decode is an
                        # error, not EOF (the chunk scan bounded the list)
                        raise VideoReadError(
                            'Undecodable MJPG chunk {} in {}'.format(
                                idx, self.path))
                    ret = True
                else:
                    ret, frame = cap.read(read_buf) if read_buf is not None \
                        else cap.read()
                if not ret:
                    break
                batch.append(self._prep_frame(frame))
                idx += 1
                if len(batch) == self.batch_size:
                    yield self._stack_batch(batch), start, len(batch)
                    batch = []
                    start = idx
            if batch:
                yield self._stack_batch(batch), start, len(batch)
            self.frames_read = idx
        finally:
            if self._demux is not None:
                self._demux.close()
            else:
                cap.release()

    def _decode_loop(self):
        try:
            for payload, start, count in self._decode_batches():
                self._queue.put(('batch', payload, start, count))
            self._queue.put(('done', None, self.frames_read, 0))
        except Exception as exc:  # surfaced on the consumer side
            self._queue.put(('error', exc, self.frames_read, 0))

    def __iter__(self):
        if self._n_stripes > 1:
            return self._iter_striped()
        if not self.threaded:
            return self._iter_inline()
        return self._iter_sequential()

    def _iter_inline(self):
        try:
            for payload, start, count in self._decode_batches():
                yield {'frames': payload, 'start': start, 'count': count}
        except VideoReadError:
            self.error_during_read = True
            raise

    def _iter_sequential(self):
        self._thread = threading.Thread(target=self._decode_loop, daemon=True)
        self._thread.start()
        while True:
            kind, payload, start, count = self._queue.get()
            if kind == 'done':
                self.frames_read = start
                return
            if kind == 'error':
                self.frames_read = start
                self.error_during_read = True
                raise VideoReadError(str(payload))
            yield {'frames': payload, 'start': start, 'count': count}

    # -- striped decode: whole batches interleaved over worker threads ------
    #
    # Worker k owns batches k, k+T, k+2T, ... and posts them, in order, to
    # its own bounded queue; the consumer round-robins queues by batch index,
    # which restores global order with per-worker backpressure and no shared
    # ordering state (a global window semaphore can deadlock: the workers
    # holding all slots may all be ahead of the next batch due).
    # Frame-exactness: each worker either reads from the shared mmap demuxer
    # (pure random access) or owns a cv2.VideoCapture seeked to the batch
    # start — gated to MJPG where frame seeks are exact (intra-only).

    def _stripe_worker(self, wid, out_q):
        T = self._n_stripes
        batch_size = self.batch_size
        total = self._total_frames
        cap = None
        seq = wid
        try:
            if self._demux is None:
                cap = cv2.VideoCapture(self.path)
                if not cap.isOpened():
                    raise VideoReadError(
                        'Cannot open file {}'.format(self.path))
            fused_fn = None
            if self._demux is not None and self.preprocess is not None:
                fused_fn = getattr(
                    self.preprocess,
                    'process_jpeg_exact' if self._exact_fused
                    else 'process_jpeg', None)
            n_batches = -(-total // batch_size)
            # A cv2-decoded container whose header UNDER-reports the frame
            # count would otherwise silently lose trailing frames (the
            # sequential path reads until cap.read() fails). The worker that
            # owns the final planned batch therefore turns it into a
            # read-to-EOF loop emitting batch_size chunks — byte-identical
            # batch boundaries to the sequential path — closed by a
            # 'tail_done' marker the consumer drains. The demux path needs
            # none of this: its chunk list is the exact ground truth.
            is_tail_owner = self._demux is None and \
                wid == (n_batches - 1) % T
            read_buf = self._read_buffer() if self._demux is None else None
            pos = -1
            while not self._stop.is_set():
                start = seq * batch_size
                if start >= total:
                    break
                if is_tail_owner and seq == n_batches - 1:
                    if pos != start:
                        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
                    idx = start
                    batch = []
                    while not self._stop.is_set():
                        ret, frame = cap.read(read_buf) if read_buf is not None else cap.read()
                        if not ret:
                            break
                        batch.append(self._prep_frame(frame))
                        idx += 1
                        if len(batch) == batch_size:
                            out_q.put(('batch', self._stack_batch(batch),
                                       idx - len(batch), len(batch)))
                            batch = []
                    if batch:
                        out_q.put(('batch', self._stack_batch(batch),
                                   idx - len(batch), len(batch)))
                    out_q.put(('tail_done', None, idx, 0))
                    return
                n = min(batch_size, total - start)
                batch = []
                short = False
                for idx in range(start, start + n):
                    if self._demux is not None:
                        entry = None
                        if fused_fn is not None:
                            entry = fused_fn(self._demux.chunk(idx))
                        if entry is None:
                            frame = self._decode_chunk_frame(idx)
                            if frame is None:
                                raise VideoReadError(
                                    'Undecodable MJPG chunk {} in {}'.format(
                                        idx, self.path))
                            entry = self._prep_frame(frame)
                        batch.append(entry)
                    else:
                        if pos != idx:
                            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                            pos = idx
                        ret, frame = cap.read(read_buf) if read_buf is not None else cap.read()
                        if not ret:
                            short = True  # EOF semantics, as sequential
                            break
                        pos += 1
                        batch.append(self._prep_frame(frame))
                payload = self._stack_batch(batch) if batch else None
                out_q.put(('short' if short else 'batch', payload, start,
                           len(batch)))
                if short:
                    break
                seq += T
        except Exception as exc:  # surfaced on the consumer side
            out_q.put(('error', exc, seq * batch_size, 0))
        finally:
            if cap is not None:
                cap.release()

    def _iter_striped(self):
        T = self._n_stripes
        self._total_frames = len(self._demux) if self._demux is not None \
            else self.frame_count
        n_batches = -(-self._total_frames // self.batch_size)
        self._tail_wid = (n_batches - 1) % T
        if self._demux is None:
            self._cap.release()  # each worker owns its own capture
        self._stop = threading.Event()
        per_worker = max(1, -(-self.prefetch // T) + 1)
        queues = [queue.Queue(maxsize=per_worker) for _ in range(T)]
        workers = [threading.Thread(target=self._stripe_worker,
                                    args=(k, queues[k]), daemon=True)
                   for k in range(T)]
        for t in workers:
            t.start()
        # on the cv2 path the final planned batch arrives as a read-to-EOF
        # tail stream closed by 'tail_done' (see _stripe_worker)
        planned = n_batches - 1 if self._demux is None else n_batches
        try:
            for expect in range(planned):
                kind, payload, start, count = queues[expect % T].get()
                if kind == 'error':
                    self.frames_read = start
                    self.error_during_read = True
                    raise VideoReadError(str(payload))
                if count:
                    yield {'frames': payload, 'start': start, 'count': count}
                if kind == 'short':
                    self.frames_read = start + count
                    return
            if self._demux is not None:
                self.frames_read = self._total_frames
                return
            while True:
                kind, payload, start, count = queues[self._tail_wid].get()
                if kind == 'error':
                    self.frames_read = start
                    self.error_during_read = True
                    raise VideoReadError(str(payload))
                if kind == 'tail_done':
                    self.frames_read = start
                    break
                if count:
                    yield {'frames': payload, 'start': start,
                           'count': count}
        finally:
            self._stop.set()
            for t in workers:
                while t.is_alive():
                    for q in queues:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass
                    t.join(0.05)
            if self._demux is not None:
                self._demux.close()


def open_video_writer(path, fourcc, fps, width, height):
    """cv2.VideoWriter with the codec settings of the reference
    (track_eval.py:1400-1405)."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                             (width, height))
    if not writer.isOpened():
        raise VideoReadError('Cannot open video writer for {}'.format(path))
    return writer
