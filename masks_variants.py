#!/usr/bin/env python3
"""The fused preprocess's design variants on one NVIDIA card.

Each variant is ``ysmr_tpu_torch/csrc/adaptive_mean.cu`` with one of the
alternatives tried for ``ysmr_adaptive_masks`` put back by a textual edit,
built with nvcc into a library of its own (under
``ysmr_tpu_torch/.build/masks_variants/``) and timed in turns with the
unedited source on the bench batch (64 x 922 x 1228 BGR frames of the
bench scene, the bench configuration's double threshold), without and
with the gray. Every variant's outputs are first held bit-equal to the
plain version.

Run from the root of a checkout on a machine with the card::

    python3 masks_variants.py [--variants a,b,...] [--rounds 2]

It prints one JSON line a variant with ptxas' registers, spill stores and
shared bytes of its bench instantiation (words, two rules, no gray), then
one line a variant and round with the median ms a launch over 20
back-to-back launches (CUDA events, median of 5) without and with the
gray; the last line is the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, 'ysmr_tpu_torch', 'csrc', 'adaptive_mean.cu')
OUT = os.path.join(HERE, 'ysmr_tpu_torch', '.build', 'masks_variants')


def _sub(src, old, new):
    if src.count(old) != 1:
        raise SystemExit('variant edit does not apply: {!r}'.format(old[:60]))
    return src.replace(old, new)


def _bounds(regs_blocks):
    return lambda s: _sub(s, '__global__ void __launch_bounds__(32, 20)',
                          '__global__ void __launch_bounds__(32, {})'.format(
                              regs_blocks))


def _band(rows):
    return lambda s: _sub(s, 'constexpr int kBandMax = 64;',
                          'constexpr int kBandMax = {};'.format(rows))


def _four_warps(s):
    """Blocks of 4 independent warps (the band and strip then come from
    threadIdx, so the compiler puts convergence barriers around every
    shuffle in a branch)."""
    s = _sub(s, '__global__ void __launch_bounds__(32, 20)',
             '__global__ void __launch_bounds__(128, 5)')
    s = _sub(s, '''  const int lane = threadIdx.x;
  const int band = blockIdx.x / a.strips;
  const int y0 = band * a.band;''', '''  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * 4 + threadIdx.x / 32;
  const int band = item / a.strips;
  const int y0 = band * a.band;
  if (y0 >= h) return;''')
    s = _sub(s, '(blockIdx.x - band * a.strips) * kStripW',
             '(item - band * a.strips) * kStripW')
    return _sub(s, 'kernel<<<dim3(blocks, 1, frames), 32, 0,',
                'kernel<<<dim3((blocks + 3) / 4, 1, frames), 128, 0,')


def _float_rules(s):
    """The rules in float32: fl(acc + 0.5) < (2^23 + blur) - (2^23 +
    bound), a compare and a select a pixel and rule."""
    s = _sub(s, '''            f[q] = __float_as_uint(
                __fadd_rd(__fadd_rn(acc, 0.5f), 8388608.0f));''',
             '''            f[q] = __float_as_uint(__fadd_rn(acc, 0.5f));''')
    s = _sub(s, '''          const uint32_t me = __byte_perm(f[0], f[2], 0x5410);
          const uint32_t mo = __byte_perm(f[1], f[3], 0x5410);
          const uint32_t ce = lanes16(cb, 0x4240), co = lanes16(cb, 0x4341);
          // bit 7 of byte q: column x + q; then keep or flip it
          auto rule = [&](uint32_t k) {
            return ((__byte_perm(ce + k - me, co + k - mo, 0x7351) >> 7) &
                    keep) ^
                   flip;
          };''', '''          auto rule = [&](float kb) {
            uint32_t lt[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float blur = __uint_as_float(
                  __byte_perm(cb, 0x4B000000u, 0x7540 + q));
              lt[q] = __uint_as_float(f[q]) < __fsub_rn(blur, kb) ? ~0u : 0u;
            }
            return (__byte_perm(__byte_perm(lt[0], lt[1], 0x3250),
                                __byte_perm(lt[2], lt[3], 0x3250), 0x5410) &
                    keep) ^
                   flip;
          };''')
    # 2^23 + bound, the bound back from the rule's constant (|bound| < 256)
    return _sub(s, '''  const uint32_t rule_mask = a.rule_mask, rule_marker = a.rule_marker;''',
                '''  const float rule_mask = 8388608.0f + static_cast<float>(
      0x8100 - static_cast<int>(a.rule_mask & 0xFFFF) - 257);
  const float rule_marker = 8388608.0f + static_cast<float>(
      0x8100 - static_cast<int>(a.rule_marker & 0xFFFF) - 257);''')


def _smem_ring(s):
    """The blurred bytes' 11-word ring in shared memory, at most 80
    registers (24 warps an SM)."""
    s = _bounds(24)(s)
    s = _sub(s, "  uint32_t bw[kTaps];  // the window rows' blurred bytes\n",
             '  __shared__ uint32_t bw_s[kTaps][32];\n')
    s = _sub(s, '          bw[j] = __byte_perm(be, bo, 0x6240);',
             '          bw_s[j][lane] = __byte_perm(be, bo, 0x6240);')
    s = _sub(s, '          bw[j] = bw[(j + 10) % kTaps];',
             '          bw_s[j][lane] = bw_s[(j + 10) % kTaps][lane];')
    return _sub(s, '          const uint32_t cb = bw[(j + 6) % kTaps];',
                '          const uint32_t cb = bw_s[(j + 6) % kTaps][lane];')


def _gray_prefetch(s):
    """With the gray, the BGR row three ahead of the loaded one into L2."""
    return _sub(s, '''            row += b + 2 < h ? pitch : -pitch;
            load_row(row);
''', '''            row += b + 2 < h ? pitch : -pitch;
            load_row(row);
            if (kGray && kWords && in && b + 4 <= b_last && b + 5 < h)
              asm volatile("prefetch.global.L2 [%0];"
                           :: "l"(row + 3 * pitch + 3 * x));
''')


def _runtime_gray(s):
    """The gray a pointer tested in the kernel, not a template argument."""
    s = _sub(s, '  if (!valid && !kGray) {', '  if (!valid && a.gray == nullptr) {')
    s = _sub(s, '  int* gray = kGray ? a.gray', '  int* gray = a.gray ? a.gray')
    return _sub(s, '    if (kGray && i >= y0 && i < y0 + rows_out) {',
                '    if (gray && i >= y0 && i < y0 + rows_out) {')


VARIANTS = {
    'final': lambda s: s,
    'four_warps': _four_warps,
    'float_rules': _float_rules,
    'regs128': _bounds(16),
    'regs80': _bounds(24),
    'smem_ring_regs80': _smem_ring,
    'band32': _band(32),
    'band128': _band(128),
    'gray_prefetch': _gray_prefetch,
    'runtime_gray': _runtime_gray,
}


def build(names):
    """One nvcc a variant, all started together; returns {name: (lib,
    ptxas record)}."""
    sys.path.insert(0, HERE)
    from ysmr_tpu_torch import _build
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        src = f.read()
    procs = {}
    for name in names:
        cu = os.path.join(OUT, name + '.cu')
        with open(cu, 'w') as f:
            f.write(VARIANTS[name](src))
        procs[name] = subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS +
            ['-shared', '-o', os.path.join(OUT, name + '.so'), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit('{} failed to build:\n{}'.format(
                name, log[-3000:]))
        rec = {'variant': name}
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if 'Function properties for' in line and \
                    'masks_kernelILb1ELb1ELb0E' in line:
                m = re.search(r'(\d+) bytes spill stores', lines[i + 1])
                rec['spill_stores'] = int(m.group(1))
                m = re.search(r'Used (\d+) registers', lines[i + 2])
                rec['registers'] = int(m.group(1))
                m = re.search(r'(\d+) bytes smem', lines[i + 2])
                rec['shared_bytes'] = int(m.group(1)) if m else 0
        lib = ctypes.CDLL(os.path.join(OUT, name + '.so'))
        lib.ysmr_adaptive_masks.restype = ci
        lib.ysmr_adaptive_masks.argtypes = [vp] * 5 + [
            ctypes.POINTER(ctypes.c_float)] + [ci] * 7 + [vp]
        out[name] = (lib, rec)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script measures the card')
    names = args.variants.split(',')
    libs = build(names)
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from ysmr_tpu_torch.ops import preprocess as pp
    from ysmr_tpu_torch.pipeline import detect
    os.makedirs(smoke.WORK, exist_ok=True)
    cfg = detect.DetectorConfig(smoke.bench_settings())
    dev = torch.device('cuda')
    scene = smoke.BenchScene()
    bgr = smoke.bgr_batch([scene.frame(t) for t in range(64)], dev)
    n, h, w = bgr.shape[:3]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    mask = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    markers = torch.empty_like(mask)
    gray = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    bounds = (pp._kernel_bound(-cfg.offset, cfg.white_on_dark),
              pp._kernel_bound(-(cfg.offset + cfg.double_delta),
                               cfg.white_on_dark))

    def launch(lib, with_gray):
        rc = lib.ysmr_adaptive_masks(
            bgr.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            markers.data_ptr(), gray.data_ptr() if with_gray else None,
            pp._K11_C, *bounds, 0 if cfg.white_on_dark else 1, n, h, w,
            dev.index or 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit('launch failed: {}'.format(rc))

    want = pp.adaptive_masks_from_bgr_plain(
        bgr, valid, cfg.mode, cfg.offset, cfg.double_delta,
        cfg.white_on_dark, True)
    for name in names:
        lib, rec = libs[name]
        launch(lib, True)
        torch.cuda.synchronize()
        rec['bit_equal'] = bool(torch.equal(mask, want[0]) and
                                torch.equal(markers, want[1]) and
                                torch.equal(gray, want[2]))
        if not rec['bit_equal']:
            raise SystemExit('{} differs from the plain version'.format(name))
        print(json.dumps(rec), flush=True)

    def per_launch(lib, with_gray, k=20):
        for _ in range(3):
            launch(lib, with_gray)
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                launch(lib, with_gray)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / k)
        return float(np.median(times))

    for r in range(args.rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            lib = libs[name][0]
            print(json.dumps({'round': r, 'variant': name,
                              'ms': per_launch(lib, False),
                              'gray_ms': per_launch(lib, True)}),
                  flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == '__main__':
    main()
