"""Build steps of the port: its CUDA kernels and, where needed, the native
host library.

Both are built at first use into ``ysmr_tpu_torch/.build/`` (listed in
``.gitignore``), under a file name keyed by a hash of the sources and flags,
so a changed source rebuilds and an unchanged one is loaded as it is.
Nothing is written into ``native/``. A failed build raises with the
compiler's output.

CUDA (``csrc/*.cu``): one ``nvcc`` per source, all started together,
then one link into a shared library with a plain C interface, loaded with
ctypes (a few seconds per build; a build through
``torch.utils.cpp_extension`` compiles PyTorch's headers and takes
minutes). Every pointer and the stream travel as ``c_void_p``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_PKG, '.build')
CSRC_DIR = os.path.join(_PKG, 'csrc')
NATIVE_DIR = os.path.join(_REPO, 'native')
#: the committed host library shared with the JAX package
NATIVE_LIBRARY = os.path.join(NATIVE_DIR, 'libysmr_native.so')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_KERNELS = None


def _digest(paths, flags):
    h = hashlib.sha256(' '.join(flags).encode())
    for p in paths:
        with open(p, 'rb') as f:
            h.update(os.path.basename(p).encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('build failed ({}):\n{}\n{}'.format(
            ' '.join(cmd), proc.stdout, proc.stderr))
    return proc.stdout + proc.stderr


def _build_once(name, sources, flags, steps):
    """Run ``steps(tmpdir, out_path) -> log`` unless the keyed output
    exists; returns (path, log). The result is renamed into place, so a
    concurrent or interrupted build never leaves a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, '{}-{}.so'.format(
        name, _digest(sources, flags)))
    if os.path.isfile(path):
        return path, ''
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, os.path.basename(path))
        log = steps(tmp, out)
        os.replace(out, path)
    return path, log


def build_native_library():
    """``native/*.cpp`` built with the flags of ``native/Makefile``
    (``-ffp-contract=off`` for the bit-exact cv2 and float64 tracker
    arithmetic; libjpeg only where its header is installed, as the
    Makefile decides). Returns the library's path."""
    cxx = os.environ.get('CXX') or 'g++'
    base = ['-march=native', '-std=c++17', '-fPIC', '-Wall']
    exact = ['-O2', '-ffp-contract=off'] + base
    main = ['-O3'] + base
    libs = []
    if os.path.isfile('/usr/include/jpeglib.h'):
        main.append('-DYSMR_WITH_JPEG')
        libs.append('-ljpeg')
    sources = [os.path.join(NATIVE_DIR, n) for n in
               ('ysmr_native.cpp', 'gray_recipe.h', 'cv2_exact.cpp',
                'tracker64.cpp')]

    def steps(tmp, out):
        log = ''
        objs = []
        for unit in ('cv2_exact', 'tracker64'):
            obj = os.path.join(tmp, unit + '.o')
            log += _run([cxx] + exact + ['-c', '-o', obj,
                                         os.path.join(NATIVE_DIR,
                                                      unit + '.cpp')], tmp)
            objs.append(obj)
        log += _run([cxx] + main + ['-shared', '-o', out,
                                    os.path.join(NATIVE_DIR,
                                                 'ysmr_native.cpp')]
                    + objs + libs, tmp)
        return log

    path, _ = _build_once('libysmr_native', sources,
                          [cxx] + exact + main + libs, steps)
    return path


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cand = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    if os.path.isfile(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)')


def load_kernels():
    """The port's CUDA kernels as a ctypes library, built on first use.

    The library carries ``build_log`` (nvcc's output, with ptxas' register
    and shared-memory report, on the call that built it) and
    ``build_path``.
    """
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    sources = sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
                     if n.endswith(('.cu', '.cuh')))
    units = [s for s in sources if s.endswith('.cu')]
    nvcc = _nvcc()

    def steps(tmp, out):
        objs = [os.path.join(tmp, os.path.basename(u) + '.o') for u in units]
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ['-c', '-o', o, u],
                                  cwd=tmp, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for u, o in zip(units, objs)]
        log = ''
        failed = []
        for u, proc in zip(units, procs):
            text = proc.communicate()[0]
            log += '{}:\n{}'.format(os.path.basename(u), text)
            if proc.returncode != 0:
                failed.append(os.path.basename(u))
        if failed:
            raise RuntimeError('build failed ({}):\n{}'.format(
                ', '.join(failed), log))
        return log + _run([nvcc] + NVCC_FLAGS[:2] + ['-shared', '-o', out] +
                          objs, tmp)

    path, log = _build_once('libysmr_kernels', sources, NVCC_FLAGS, steps)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ysmr_run_prop.restype = ci
    lib.ysmr_run_prop.argtypes = [vp] * 12 + [ci] * 4 + [vp]
    lib.ysmr_run_prepare.restype = ci
    lib.ysmr_run_prepare.argtypes = [vp] * 10 + [ci] * 8 + [vp]
    lib.ysmr_run_compact.restype = ci
    lib.ysmr_run_compact.argtypes = [vp, vp, vp, ctypes.POINTER(vp),
                                     ctypes.POINTER(vp)] + [vp] * 7 + \
        [ci] * 4 + [vp]
    lib.ysmr_run_finish.restype = ci
    lib.ysmr_run_finish.argtypes = [vp] * 17 + [ci] * 7 + [vp]
    lib.ysmr_run_scratch_words.restype = ctypes.c_int64
    lib.ysmr_run_scratch_words.argtypes = [ci] * 3
    lib.ysmr_compact_scratch_words.restype = ctypes.c_int64
    lib.ysmr_compact_scratch_words.argtypes = [ci] * 3
    lib.ysmr_hull_edges.restype = ci
    lib.ysmr_hull_edges.argtypes = [vp] * 14 + [ci, ci, ci, vp]
    lib.ysmr_sweep_extents.restype = ci
    lib.ysmr_sweep_extents.argtypes = [vp] * 12 + [ci, ci, ci, ci, vp]
    lib.ysmr_row_min_argmin.restype = ci
    lib.ysmr_row_min_argmin.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.ysmr_cc_label.restype = ci
    lib.ysmr_cc_label.argtypes = [vp] * 3 + [ci] * 5 + [vp]
    lib.ysmr_cc_reconstruct.restype = ci
    lib.ysmr_cc_reconstruct.argtypes = [vp] * 5 + [ci, ci, ci, ci, vp]
    lib.ysmr_compact_row_tables.restype = ci
    lib.ysmr_compact_row_tables.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.ysmr_cc_pixels.restype = ci
    lib.ysmr_cc_pixels.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.ysmr_table_cc.restype = ci
    lib.ysmr_table_cc.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.ysmr_expand_runs.restype = ci
    lib.ysmr_expand_runs.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.ysmr_adaptive_mean.restype = ci
    lib.ysmr_adaptive_mean.argtypes = [vp, vp, ctypes.POINTER(
        ctypes.c_float)] + [ci] * 4 + [vp]
    lib.ysmr_adaptive_masks.restype = ci
    lib.ysmr_adaptive_masks.argtypes = [vp] * 5 + [ctypes.POINTER(
        ctypes.c_float)] + [ci] * 7 + [vp]
    lib.ysmr_mean_prepare.restype = ci
    lib.ysmr_mean_prepare.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.ysmr_mean_masks.restype = ci
    lib.ysmr_mean_masks.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.ysmr_gsff_step.restype = ci
    lib.ysmr_gsff_step.argtypes = [vp] * 21 + [ci] * 6 + \
        [ctypes.c_longlong, ci, vp]
    lib.ysmr_frame_step.restype = ci
    lib.ysmr_frame_step.argtypes = [vp] * 27 + [ctypes.c_float] + \
        [ci] * 6 + [vp]
    ll = ctypes.c_longlong
    lib.ysmr_cv2_centers.restype = ci
    lib.ysmr_cv2_centers.argtypes = [vp] * 9 + [ll] + [ci] * 4 + [vp]
    lib.ysmr_cv2_inv_sqrt.restype = ci
    lib.ysmr_cv2_inv_sqrt.argtypes = [vp, ci, ci, vp]
    lib.ysmr_edge_finish.restype = ci
    lib.ysmr_edge_finish.argtypes = [vp] * 10 + [ll, ci, ci, vp]
    lib.ysmr_rect_select.restype = ci
    lib.ysmr_rect_select.argtypes = [vp] * 13 + [ll, ci, ci, vp]
    lib.ysmr_rect_mean_lum.restype = ci
    lib.ysmr_rect_mean_lum.argtypes = [vp, ci] + [vp] * 7 + [ci] * 6 + [vp]
    lib.ysmr_pixel_finish.restype = ci
    lib.ysmr_pixel_finish.argtypes = [vp] * 13 + [ci] * 8 + [vp]
    lib.ysmr_pixel_finish_scratch_words.restype = ll
    lib.ysmr_pixel_finish_scratch_words.argtypes = [ci, ci]
    lib.ysmr_rect_sqrt_mismatches.restype = ci
    lib.ysmr_rect_sqrt_mismatches.argtypes = [vp, ci, vp]
    lib.ysmr_cuda_error_string.restype = ctypes.c_char_p
    lib.ysmr_cuda_error_string.argtypes = [ci]
    lib.build_log = log
    lib.build_path = path
    _KERNELS = lib
    return lib


def check(lib, rc, what):
    """Raise on a non-zero CUDA status returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError('{} failed: CUDA error {} ({})'.format(
            what, rc, lib.ysmr_cuda_error_string(rc).decode()))
