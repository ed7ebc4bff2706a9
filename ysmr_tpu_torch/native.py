# Copied from ysmr_tpu/native.py; the import lines, the library lookup
# (_open_library) and the search for cv2's ffmpeg (_cv2_bundled_ffmpeg, which
# also looks in the folders of cv2's other wheels, such as the headless one)
# differ.
#!/usr/bin/env python3
"""ctypes bindings for the native C++ runtime components (native/).

Loads ``libysmr_native.so`` if built (``make -C native``); every entry point
has a pure-Python fallback so the framework runs without the native library.
"""

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = _open_library()
        lib.format_rows.restype = ctypes.c_int64
        lib.format_rows.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_char)]
        lib.format_table.restype = ctypes.c_int64
        lib.format_table.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p]
        lib.min_area_rect_batch.restype = None
        lib.min_area_rect_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.extract_fg_pixels.restype = ctypes.c_int64
        lib.extract_fg_pixels.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.preprocess_stage1.restype = None
        lib.preprocess_stage1.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.preprocess_stage2.restype = ctypes.c_int64
        lib.preprocess_stage2.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        try:
            lib.decode_jpeg_gray_stage1.restype = ctypes.c_int64
            lib.decode_jpeg_gray_stage1.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        except AttributeError:  # built without libjpeg
            pass
        lib.preprocess_stage2_packed.restype = ctypes.c_int64
        lib.preprocess_stage2_packed.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
        try:
            lib.preprocess_stage2_fused.restype = ctypes.c_int64
            lib.preprocess_stage2_fused.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
        except AttributeError:  # stale .so predating the fused stage 2
            pass
        lib.gray_at_pixels.restype = None
        lib.gray_at_pixels.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int16)]
        lib.encode_runs_batch.restype = ctypes.c_int64
        lib.encode_runs_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        try:
            lib.expand_run_det.restype = None
            lib.expand_run_det.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int16)]
        except AttributeError:
            pass  # older library build
        lib.cv2_rects_batch.restype = ctypes.c_int
        lib.cv2_rects_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.cv2_min_area_rect_single.restype = ctypes.c_int
        lib.cv2_min_area_rect_single.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.tracker64_create.restype = ctypes.c_void_p
        lib.tracker64_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_double]
        lib.tracker64_destroy.restype = None
        lib.tracker64_destroy.argtypes = [ctypes.c_void_p]
        lib.tracker64_update_batch.restype = ctypes.c_int64
        lib.tracker64_update_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_int64]
        lib.tracker64_fetch.restype = ctypes.c_int64
        lib.tracker64_fetch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.tracker64_next_id.restype = ctypes.c_int64
        lib.tracker64_next_id.argtypes = [ctypes.c_void_p]
        lib.tracker64_live_count.restype = ctypes.c_int64
        lib.tracker64_live_count.argtypes = [ctypes.c_void_p]
        lib.stage1_acquire_gray.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.stage1_acquire_gray.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.stage1_run_from_gray.restype = None
        lib.stage1_run_from_gray.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    except (OSError, AttributeError):
        # missing library, or a stale .so lacking a required symbol: fall
        # back to the pure-Python paths rather than crash mid-pipeline
        _LIB = None
    return _LIB


def _open_library():
    """The shared ``native/libysmr_native.so``, or this package's own build
    of the same sources (``_build.build_native_library``) when the committed
    binary does not load on this host (built elsewhere with
    ``-march=native``, or linked against a libjpeg this host lacks). A
    failed build raises."""
    from ysmr_tpu_torch import _build
    try:
        return ctypes.CDLL(_build.NATIVE_LIBRARY)
    except OSError:
        return ctypes.CDLL(_build.build_native_library())


def available():
    return _load() is not None


_AVDEC = None
_AVDEC_TRIED = False


def _load_avdec():
    """Optional exact-decode module (libysmr_avdec.so: libavcodec MJPEG +
    libswscale + the exact gray recipe). Separate from the core library so
    its ffmpeg linkage cannot break everything else."""
    global _AVDEC, _AVDEC_TRIED
    if _AVDEC_TRIED:
        return _AVDEC
    _AVDEC_TRIED = True
    if _load() is None:  # stage-1 buffers live in the core library
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'native', 'libysmr_avdec.so')
    if not os.path.isfile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.avdec_init.restype = ctypes.c_int
        lib.avdec_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.avdec_loaded_version.restype = ctypes.c_uint
        lib.avdec_loaded_version.argtypes = []
        lib.avdec_available.restype = ctypes.c_int
        lib.avdec_available.argtypes = []
        lib.avdec_decode.restype = ctypes.c_int
        lib.avdec_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.avdec_frame_to_gray.restype = ctypes.c_int
        lib.avdec_frame_to_gray.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.avdec_frame_to_bgr.restype = ctypes.c_int
        lib.avdec_frame_to_bgr.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.avdec_gray_fast_frames.restype = ctypes.c_long
        lib.avdec_gray_fast_frames.argtypes = []
        lib.avdec_gray_fast_status.restype = ctypes.c_int
        lib.avdec_gray_fast_status.argtypes = []
        lib.avdec_frame_plane.restype = ctypes.c_int
        lib.avdec_frame_plane.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        try:
            # first-party MJPEG decoder (optional: absent in a stale .so)
            lib.avdec_jdec_gray.restype = ctypes.c_int
            lib.avdec_jdec_gray.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.avdec_jdec_frames.restype = ctypes.c_long
            lib.avdec_jdec_frames.argtypes = []
            lib._has_jdec = True
        except AttributeError:
            lib._has_jdec = False
        av_path, sws_path = _cv2_bundled_ffmpeg()
        if not lib.avdec_init(av_path, sws_path):
            return None
        if not lib.avdec_available():
            return None
        _AVDEC = lib
    except (OSError, AttributeError):
        _AVDEC = None
    return _AVDEC


def _cv2_bundled_ffmpeg(site=None):
    """Paths of the libavcodec/libswscale copies cv2 ships with itself, or
    (None, None): those of ``opencv_python.libs/`` beside cv2's package in
    ``site`` (cv2's site-packages by default), else those of the first
    other ``opencv*.libs/`` folder that holds both (the headless and
    contrib wheels name their folders after themselves).

    Running cv2's own ffmpeg build guarantees the exact decoder arithmetic
    the reference sees through cv2.VideoCapture. The first-frame
    byte-compare in io/video.py remains the authority.
    """
    try:
        import glob
        if site is None:
            import cv2
            site = os.path.dirname(os.path.dirname(os.path.abspath(
                cv2.__file__)))
        for libs_dir in [os.path.join(site, 'opencv_python.libs')] + sorted(
                glob.glob(os.path.join(site, 'opencv*.libs'))):
            avc = sorted(glob.glob(os.path.join(libs_dir, 'libavcodec*.so*')))
            sws = sorted(glob.glob(os.path.join(libs_dir, 'libswscale*.so*')))
            if avc and sws:
                return avc[-1].encode(), sws[-1].encode()
    except Exception:
        pass
    return None, None


def avdec_available():
    return _load_avdec() is not None


def avdec_gray_fast_stats():
    """(frames_via_lut, proof_status) of avdec's gray-content fast path.

    Status: 0 = not yet evaluated, 1 = LUT identity proven for the current
    geometry (uniform-128-chroma frames skip swscale), -1 = refuted (every
    frame takes the full converter). Diagnostics/tests only.
    """
    av = _load_avdec()
    if av is None:
        return 0, 0
    return int(av.avdec_gray_fast_frames()), int(av.avdec_gray_fast_status())


def avdec_jdec_frames():
    """How many frames the first-party MJPEG decoder served (diagnostics);
    0 when the module or the entry point is unavailable."""
    av = _load_avdec()
    if av is None or not getattr(av, '_has_jdec', False):
        return 0
    return int(av.avdec_jdec_frames())


def avdec_decode_planes(jpg):
    """Decode one JPEG chunk and return its raw planes (Y, U, V) as numpy
    arrays — ground truth for validating the first-party MJPEG decoder
    (native/jpegdec.cpp) against libavcodec's exact output."""
    av = _load_avdec()
    if av is None:
        return None
    buf = _as_u8_buf(jpg)
    dims = np.zeros(2, np.int64)
    if av.avdec_decode(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       len(buf),
                       dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
        return None
    planes = []
    for p in range(3):
        out = np.empty(int(dims[0]) * int(dims[1]), np.uint8)
        pd = np.zeros(2, np.int64)
        if av.avdec_frame_plane(
                p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(out), pd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
            return None
        planes.append(out[:int(pd[0]) * int(pd[1])].reshape(
            int(pd[1]), int(pd[0])).copy())
    return planes


def _as_u8_buf(jpg):
    buf = np.frombuffer(jpg, np.uint8) if not isinstance(jpg, np.ndarray) \
        else jpg
    return buf


def _jpeg_sof_dims(buf):
    """(h, w) from a baseline JPEG's SOF0 marker, or None. Tiny marker walk
    so the jdec path can size the stage-1 buffer before decoding."""
    n = len(buf)
    if n < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    i = 2
    while i + 4 <= n:
        if buf[i] != 0xFF:
            return None
        m = int(buf[i + 1])
        i += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if i + 2 > n:
            return None
        ln = (int(buf[i]) << 8) | int(buf[i + 1])
        if m == 0xC0:
            if ln < 7 or i + 7 > n:
                return None
            h = (int(buf[i + 3]) << 8) | int(buf[i + 4])
            w = (int(buf[i + 5]) << 8) | int(buf[i + 6])
            return (h, w) if h > 0 and w > 0 else None
        if m == 0xDA:
            return None
        i += ln
    return None


#: first-party MJPEG decoder guard: geometries whose first jdec-served
#: frame byte-matched the avcodec path, and the process-wide kill switch
_jdec_verified = set()
_jdec_disabled = False


def _jdec_try_stage1(av, core, buf, h, w):
    """Serve one frame through the first-party MJPEG decoder straight into
    the stage-1 gray buffer. The first frame jdec serves per geometry is
    byte-compared against the avcodec path (itself validated against
    cv2.read by the reader's per-file self-check); any mismatch disables
    jdec for the process. False => caller runs the avcodec path."""
    global _jdec_disabled
    gray_ptr = core.stage1_acquire_gray(h, w)
    if not gray_ptr:
        return False
    pd = np.zeros(2, np.int64)
    rc = av.avdec_jdec_gray(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        gray_ptr, h * w, pd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return False
    if (h, w) not in _jdec_verified:
        got = np.ctypeslib.as_array(gray_ptr, shape=(h * w,)).copy()
        ref = avdec_decode_gray(buf)
        if ref is None or not np.array_equal(ref.ravel(), got):
            _jdec_disabled = True
            return False
        _jdec_verified.add((h, w))
    return True


def avdec_gray_stage1(jpg, need_mean, want_stats=False):
    """Exact-decode one JPEG chunk + stage 1, mirroring
    ``decode_jpeg_gray_stage1``'s contract: gray = the exact BGR2GRAY recipe
    applied to libswscale's BGR24 (cv2's own decode arithmetic), written
    straight into the thread's stage-1 buffer. Frames are served by the
    first-party MJPEG decoder (avdec_jdec_gray) when its exactness
    preconditions hold — proven gray LUT, located idct_put, baseline
    cv2-writer profile — with a first-serve byte-compare guard per
    geometry; everything else runs the regular libavcodec path.

    :return: (h, w) on success (+stats array when requested), None when the
        module is unavailable or the frame failed to decode
    """
    core = _load()
    av = _load_avdec()
    if core is None or av is None:
        return None
    buf = _as_u8_buf(jpg)
    h = w = None
    if getattr(av, '_has_jdec', False) and not _jdec_disabled:
        sof = _jpeg_sof_dims(buf)
        if sof is not None and _jdec_try_stage1(av, core, buf, *sof):
            h, w = sof
    if h is None:
        dims = np.zeros(2, np.int64)
        if av.avdec_decode(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(buf),
                dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
            return None
        h, w = int(dims[0]), int(dims[1])
        gray_ptr = core.stage1_acquire_gray(h, w)
        if not gray_ptr:
            return None
        if av.avdec_frame_to_gray(gray_ptr, h * w):
            return None
    stats = np.zeros(2, np.float64) if want_stats else None
    core.stage1_run_from_gray(
        h, w, 1 if need_mean else 0,
        stats.ctypes.data_as(ctypes.c_void_p) if want_stats else None)
    return ((h, w), stats) if want_stats else (h, w)


def avdec_decode_gray(jpg):
    """Decode one JPEG chunk to a (h, w) exact-gray frame via the avdec
    module's libavcodec path, INCLUDING the gray-content LUT fast path when
    it is armed. Used by the reader's first-frame self-check (vs cv2.read)
    and as the reference the first-party jdec decoder is byte-compared
    against on its first served frame per geometry. None on failure."""
    av = _load_avdec()
    if av is None:
        return None
    buf = _as_u8_buf(jpg)
    dims = np.zeros(2, np.int64)
    if av.avdec_decode(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       len(buf),
                       dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
        return None
    h, w = int(dims[0]), int(dims[1])
    out = np.empty((h, w), np.uint8)
    if av.avdec_frame_to_gray(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size):
        return None
    return out


def avdec_decode_bgr(jpg):
    """Decode one JPEG chunk to a (h, w, 3) BGR frame via the avdec module
    (used by the first-frame parity self-check). None on failure."""
    av = _load_avdec()
    if av is None:
        return None
    buf = _as_u8_buf(jpg)
    dims = np.zeros(2, np.int64)
    if av.avdec_decode(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       len(buf),
                       dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
        return None
    h, w = int(dims[0]), int(dims[1])
    out = np.empty((h, w, 3), np.uint8)
    if av.avdec_frame_to_bgr(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size):
        return None
    return out


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


#: format_table column type tags (must match native/ysmr_native.cpp)
TABLE_INT64 = 0
TABLE_FLOAT64 = 1
TABLE_BOOL = 2
TABLE_FLOAT16 = 4
TABLE_BYTES = 5

#: conservative per-value byte budgets for the output buffer
_TABLE_WIDTHS = {TABLE_INT64: 21, TABLE_FLOAT64: 26, TABLE_BOOL: 6,
                 TABLE_FLOAT16: 14}


def format_table(columns):
    """CSV bytes for typed columns; None if the library is missing.

    :param columns: list of (type_tag, contiguous ndarray) pairs —
        TABLE_INT64: int64, TABLE_FLOAT64: float64 (NaN renders as ``""``),
        TABLE_BOOL: uint8/bool, TABLE_FLOAT16: float16 (raw half bits),
        TABLE_BYTES: fixed-width ``S``-dtype bytes (NUL-padded)
    :return: bytes of all data rows (no header), or None
    """
    lib = _load()
    if lib is None:
        return None
    k = len(columns)
    n = len(columns[0][1]) if k else 0
    types = np.zeros(k, np.int32)
    widths = np.zeros(k, np.int64)
    ptrs = (ctypes.c_void_p * k)()
    arrays = []  # keep references alive
    budget = 1
    for i, (tag, arr) in enumerate(columns):
        if tag == TABLE_FLOAT16:
            arr = np.ascontiguousarray(arr, dtype=np.float16).view(np.uint16)
        elif tag == TABLE_BOOL:
            arr = np.ascontiguousarray(arr).astype(np.uint8)
        elif tag == TABLE_BYTES:
            arr = np.ascontiguousarray(arr)
            widths[i] = arr.dtype.itemsize
        elif tag == TABLE_INT64:
            arr = np.ascontiguousarray(arr, dtype=np.int64)
        else:
            arr = np.ascontiguousarray(arr, dtype=np.float64)
        arrays.append(arr)
        types[i] = tag
        ptrs[i] = arr.ctypes.data
        budget += (_TABLE_WIDTHS.get(tag) or int(widths[i])) + 1
    buf = ctypes.create_string_buffer(max(n, 1) * budget)
    written = lib.format_table(
        n, k, types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ptrs, buf)
    return buf.raw[:written]


def format_rows_bytes(track_id, frame, x, y, w, h, deg, illumination=None):
    """CSV rows for packed result columns as a bytes-like view (no str
    round trip: the buffer is written once by the C formatter and handed to
    the file layer as a memoryview); None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    n = len(track_id)
    tid = np.ascontiguousarray(track_id, dtype=np.int64)
    frm = np.ascontiguousarray(frame, dtype=np.int64)
    cols = [np.ascontiguousarray(c, dtype=np.float64) for c in (x, y, w, h, deg)]
    lum = None
    lum_ptr = None
    if illumination is not None:
        lum = np.ascontiguousarray(illumination, dtype=np.float64)
        lum_ptr = lum.ctypes.data_as(ctypes.c_void_p)
    # np.empty: the formatter overwrites [0, written) and nothing reads
    # beyond it, so the ~20 MB memset of a zeroed buffer is pure waste
    buf = np.empty(n * 160, np.uint8)
    written = lib.format_rows(
        tid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        frm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _dp(cols[0]), _dp(cols[1]), _dp(cols[2]), _dp(cols[3]), _dp(cols[4]),
        lum_ptr, n, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)))
    return memoryview(buf)[:written]


def format_rows(track_id, frame, x, y, w, h, deg, illumination=None):
    """CSV text for packed result columns; None if the library is missing."""
    raw = format_rows_bytes(track_id, frame, x, y, w, h, deg, illumination)
    return None if raw is None else bytes(raw).decode('ascii')


def extract_fg_pixels(mask_u8, markers_u8, xs, ys, flags):
    """Single-pass foreground pixel extraction into preallocated buffers.

    :param mask_u8: (H, W) uint8 C-contiguous (0 = background)
    :param markers_u8: optional (H, W) uint8 or None
    :param xs, ys: (max_out,) int16 output buffers
    :param flags: (max_out,) uint8 output buffer (marker membership)
    :return: total fg count (may exceed buffer size), or None if unavailable
    """
    lib = _load()
    if lib is None:
        return None
    h, w = mask_u8.shape
    mptr = markers_u8.ctypes.data_as(ctypes.c_void_p) if markers_u8 is not None \
        else None
    return lib.extract_fg_pixels(
        mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), mptr, h, w,
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(xs))


def preprocess_stage1_only(frame, need_mean, want_stats=False):
    """Native gray -> blur (-> adaptive mean) into thread-local buffers.

    :param frame: (H, W) or (H, W, 3) uint8 C-contiguous (BGR)
    :param want_stats: also return (sum, sum_sq) of the gray image, which the
        mean-threshold mode needs BEFORE choosing this frame's threshold
    :return: stats ndarray, True, or None if the library is missing
    """
    lib = _load()
    if lib is None:
        return None
    h, w = frame.shape[:2]
    channels = 3 if frame.ndim == 3 else 1
    stats = np.zeros(2, np.float64) if want_stats else None
    lib.preprocess_stage1(
        frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, channels,
        1 if need_mean else 0,
        stats.ctypes.data_as(ctypes.c_void_p) if want_stats else None)
    return stats if want_stats else True


def preprocess_stage2_only(mode, white, c_mask, c_marker, global_thresh,
                           xs, ys, flags):
    """Threshold + extraction from the thread's stage-1 buffers (mean mode)."""
    lib = _load()
    if lib is None:
        return None
    return lib.preprocess_stage2(
        int(mode), 1 if white else 0, float(c_mask), float(c_marker),
        int(global_thresh),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(xs))


def decode_jpeg_gray_stage1(jpg, need_mean, want_stats=False):
    """Fused JPEG-grayscale decode + stage 1 into thread-local buffers.

    :param jpg: bytes-like / uint8 ndarray with one complete JPEG
    :return: (h, w) on success (+stats array when requested), None when the
        library lacks jpeg support or the frame failed to decode
    """
    lib = _load()
    if lib is None or not hasattr(lib, 'decode_jpeg_gray_stage1'):
        return None
    buf = np.frombuffer(jpg, np.uint8) if not isinstance(jpg, np.ndarray) \
        else jpg
    stats = np.zeros(2, np.float64) if want_stats else None
    dims = np.zeros(2, np.int64)
    rc = lib.decode_jpeg_gray_stage1(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        1 if need_mean else 0,
        stats.ctypes.data_as(ctypes.c_void_p) if want_stats else None,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    out = (int(dims[0]), int(dims[1]))
    return (out, stats) if want_stats else out


def preprocess_stage2_packed(mode, white, c_mask, c_marker, global_thresh,
                             packed):
    """Threshold + extraction into a packed uint32 wire buffer
    (bits 0..30 = linear index, bit 31 = marker)."""
    lib = _load()
    if lib is None:
        return None
    return lib.preprocess_stage2_packed(
        int(mode), 1 if white else 0, float(c_mask), float(c_marker),
        int(global_thresh),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(packed))


def stage1_rerun_from_gray(h, w, need_mean, want_stats=False):
    """Re-run blur3 (+ adaptive mean) from the thread's already-filled gray
    buffer — the recovery path when a caller skipped the mean plane for the
    fused stage 2 and then needs it after all."""
    lib = _load()
    if lib is None:
        return None
    stats = np.zeros(2, np.float64) if want_stats else None
    lib.stage1_run_from_gray(
        h, w, 1 if need_mean else 0,
        stats.ctypes.data_as(ctypes.c_void_p) if want_stats else None)
    return stats if want_stats else True


def has_fused_stage2():
    """True when the library exports the fused adaptive-mean stage 2."""
    lib = _load()
    return lib is not None and hasattr(lib, 'preprocess_stage2_fused')


def preprocess_stage2_fused(mode, white, c_mask, c_marker, packed):
    """Fused adaptive mean + threshold + extraction (modes 0/1 only).

    Stage 1 must have run with ``need_mean=False``; the mean plane is never
    materialized — the 11-tap vertical pass thresholds in-register and
    emits the packed uint32 wire directly. Bit-identical to
    ``preprocess_stage1_only(need_mean=True)`` + ``preprocess_stage2_packed``.
    Returns the total foreground count, or None when unavailable.
    """
    lib = _load()
    if lib is None or not hasattr(lib, 'preprocess_stage2_fused'):
        return None
    rc = lib.preprocess_stage2_fused(
        int(mode), 1 if white else 0, float(c_mask), float(c_marker),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(packed))
    return None if rc < 0 else rc


def gray_at_pixels(xs, ys, n, out):
    """Grayscale at pixels from the thread's stage-1 gray buffer."""
    lib = _load()
    if lib is None:
        return None
    lib.gray_at_pixels(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return True


def min_area_rect_batch(pts_xy, valid):
    """Exact hull+calipers rects for packed candidate points.

    :param pts_xy: (D, P, 2) float32; valid (D, P) bool/uint8
    :return: (D, 5) float32 [cx, cy, w, h, angle_deg], or None if unavailable
    """
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts_xy, dtype=np.float32)
    v = np.ascontiguousarray(valid, dtype=np.uint8)
    d, p = v.shape
    out = np.zeros((d, 5), dtype=np.float32)
    lib.min_area_rect_batch(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        d, p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def cv2_rects_batch(px_packed, counts, det_idx, w, max_det):
    """Bit-exact cv2.minAreaRect measurements for a batch of frames.

    Replicates the reference's cv2.minAreaRect(findContours(...)) chain to
    the last float bit (native/cv2_exact.cpp; reference implementation and
    provenance in ops/cv2_exact.py).

    :param px_packed: (T, F) uint32 wire pixels (bits 0..30 = y*w + x,
        raster order per frame)
    :param counts: (T,) int32 valid pixels per frame
    :param det_idx: (T, F) int16 detection index per pixel, -1 = none
    :param w: frame width; max_det: detection slots per frame
    :return: ((T, max_det, 5) float32 [cx, cy, w, h, angle],
        (T, max_det) bool) or None if the library is missing
    """
    lib = _load()
    if lib is None:
        return None
    pp = np.ascontiguousarray(px_packed, dtype=np.uint32)
    cc = np.ascontiguousarray(counts, dtype=np.int32)
    di = np.ascontiguousarray(det_idx, dtype=np.int16)
    t, f = pp.shape
    out = np.empty((t, max_det, 5), dtype=np.float32)
    valid = np.empty((t, max_det), dtype=np.uint8)
    rc = lib.cv2_rects_batch(
        pp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        di.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        t, f, int(w), int(max_det),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out, valid.astype(bool)


class Tracker64:
    """Float64 host tracker (native/tracker64.cpp): the reference's
    CentroidTracker + GSFF arithmetic semantics, fed with detection rects a
    batch at a time, emitting the finished result rows directly on the host.

    :param dims: 2 or 3 (with luminosity)
    :param gsff_params: ops.gsff.GSFFParams or None to disable the filter
    """

    def __init__(self, dims, max_disappeared, gsff_params=None,
                 likelihood_minimum=1e-20):
        lib = _load()
        if lib is None:
            raise RuntimeError('native library unavailable')
        self._lib = lib
        self.dims = dims
        self.use_gsff = gsff_params is not None
        if self.use_gsff:
            n_i = np.asarray(gsff_params.n_i, np.int32)
            gains = np.ascontiguousarray(gsff_params.gains_f64, np.float64)
            self._h = lib.tracker64_create(
                int(dims), 1, float(max_disappeared), int(gsff_params.n_f),
                n_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                int(gsff_params.n_max),
                gains.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                float(likelihood_minimum))
        else:
            self._h = lib.tracker64_create(
                int(dims), 0, float(max_disappeared), 0, None, 0, None,
                float(likelihood_minimum))

    def update_batch(self, rects, valid, frame0, lum=None):
        """Track T frames of detections; returns the emitted rows as column
        arrays sorted by (frame, id).

        :param rects: (T, D, 5) float32 [cx, cy, w, h, angle]
        :param valid: (T, D) bool/uint8
        :param frame0: absolute frame number of rects[0]
        :param lum: optional (T, D) float32 ILLUMINATION per detection
        """
        lib = self._lib
        r = np.ascontiguousarray(rects, np.float32)
        v = np.ascontiguousarray(valid, np.uint8)
        t, d = v.shape
        lp = None
        if lum is not None:
            lum = np.ascontiguousarray(lum, np.float32)
            lp = lum.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lib.tracker64_update_batch(
            self._h, r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), lp,
            t, d, int(frame0))
        ids = np.empty(n, np.int64)
        frames = np.empty(n, np.int64)
        xs = np.empty(n, np.float64)
        ys = np.empty(n, np.float64)
        lums = np.empty(n, np.float64) if self.dims == 3 else None
        ws = np.empty(n, np.float64)
        hs = np.empty(n, np.float64)
        degs = np.empty(n, np.float64)
        lib.tracker64_fetch(
            self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lums.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if lums is not None else None,
            ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            hs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            degs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        order = np.lexsort((ids, frames))
        out = {'TRACK_ID': ids[order], 'POSITION_T': frames[order],
               'POSITION_X': xs[order], 'POSITION_Y': ys[order],
               'WIDTH': ws[order], 'HEIGHT': hs[order],
               'DEGREES_ANGLE': degs[order]}
        if lums is not None:
            out['ILLUMINATION'] = lums[order]
        return out

    @property
    def next_id(self):
        return int(self._lib.tracker64_next_id(self._h))

    def __del__(self):
        try:
            self._lib.tracker64_destroy(self._h)
        except Exception:
            pass


def cv2_min_area_rect_single(pts_xy):
    """cv2.minAreaRect on one int point sequence (tests/debug).

    :param pts_xy: (N, 2) int array
    :return: (5,) float32 [cx, cy, w, h, angle] or None if unavailable
    """
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts_xy, dtype=np.int32)
    out = np.empty(5, dtype=np.float32)
    rc = lib.cv2_min_area_rect_single(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(pts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out


def encode_runs_batch(px_packed, counts, out_runs, out_counts, w=0):
    """Run-length-encode a packed pixel wire batch (native encoder).

    Raster-order foreground pixels form horizontal runs; the run wire
    (uint32: start lin 0..25, marker bit 26, length 1..31 bits 27..31)
    cuts host->device traffic ~4-5x at dense scale and is expanded back to
    the identical pixel table on device (detect_from_pixels).

    :param px_packed: (T, F) uint32 wire pixels (raster order per frame)
    :param counts: (T,) int32 valid pixels per frame
    :param out_runs: (T, R) uint32 output buffer (written in place)
    :param out_counts: (T,) int32 output runs per frame (written in place)
    :param w: frame width; when > 0, runs additionally split at row
        boundaries (required by the device run-graph CC, which consumes
        runs as per-row x-intervals)
    :return: max runs in any frame; -1 if a frame overflows R; -2 if a
        linear index exceeds the 26-bit start field; None without the
        native library (callers use :func:`encode_runs_numpy`)
    """
    lib = _load()
    if lib is None:
        return None
    pp = np.ascontiguousarray(px_packed, dtype=np.uint32)
    cc = np.ascontiguousarray(counts, dtype=np.int32)
    t, f = pp.shape
    assert out_runs.shape[0] == t and out_counts.shape[0] == t
    return int(lib.encode_runs_batch(
        pp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t, f,
        out_runs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_runs.shape[1],
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), int(w)))


def expand_run_det(px_runs, run_counts, det_run, f):
    """Expand per-RUN detection indices to the (T, F) per-pixel wire-order
    table (host-rect mode, runs det readback) — the C counterpart of
    track_bacteria._expand_run_det (np.repeat per frame cost ~1-2 ms/frame
    at dense scale).

    :param px_runs: (T, R) uint32 run wire (length in bits 27..31)
    :param run_counts: (T,) int32 runs per frame
    :param det_run: (T, Rd) int16 per-run detection indices
    :param f: output pixel-table width
    :return: (T, F) int16 per-pixel det indices (-1 padding), or None
        without the native library
    """
    lib = _load()
    if lib is None or not hasattr(lib, 'expand_run_det'):
        return None
    rr = np.ascontiguousarray(px_runs, dtype=np.uint32)
    cc = np.ascontiguousarray(run_counts, dtype=np.int32)
    dd = np.ascontiguousarray(det_run, dtype=np.int16)
    t = rr.shape[0]
    out = np.empty((t, int(f)), np.int16)
    lib.expand_run_det(
        rr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dd.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        t, rr.shape[1], dd.shape[1], int(f),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out


def encode_runs_numpy(px_packed, counts, out_runs, out_counts, w=0):
    """Vectorised numpy fallback of :func:`encode_runs_batch` (same
    contract, same wire format)."""
    pp = np.asarray(px_packed, dtype=np.uint32)
    t, f = pp.shape
    r = out_runs.shape[1]
    max_runs = 0
    for ti in range(t):
        n = int(min(max(counts[ti], 0), f))
        if n == 0:
            out_counts[ti] = 0
            continue
        row = pp[ti, :n]
        lin = (row & np.uint32(0x7FFFFFFF)).astype(np.int64)
        if lin[-1] >= (1 << 26):
            return -2
        marker = (row >> np.uint32(31)).astype(np.int64)
        idx = np.arange(n, dtype=np.int64)
        # natural boundaries: non-consecutive lin or marker change; with a
        # known width also any pixel starting an image row (run-graph CC
        # consumes runs as per-row x-intervals)
        nat = np.ones(n, bool)
        nat[1:] = (np.diff(lin) != 1) | (np.diff(marker) != 0)
        if w > 0:
            nat |= (lin % w) == 0
        # split runs longer than 31: boundary whenever the offset within
        # the natural run hits a multiple of 31
        run_start = np.maximum.accumulate(np.where(nat, idx, 0))
        bound = nat | ((idx - run_start) % 31 == 0)
        starts = np.nonzero(bound)[0]
        nr = len(starts)
        if nr > r:
            return -1
        lens = np.diff(np.append(starts, n))
        out_runs[ti, :nr] = (lin[starts].astype(np.uint32) |
                             (marker[starts].astype(np.uint32) << 26) |
                             (lens.astype(np.uint32) << 27))
        out_counts[ti] = nr
        max_runs = max(max_runs, nr)
    return max_runs
