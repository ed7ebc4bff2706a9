# Copied from ysmr_tpu/__main__.py; the differences are --device and the
# package name.
#!/usr/bin/env python3
"""Command-line launcher: ``python -m ysmr_tpu_torch`` starts the full
pipeline (the ``ysmr-tpu-torch`` console script runs the same ``cli``).

Mirrors the reference's top-level launcher (ysmr.py:18-21), which simply
calls ``ysmr()`` — the interactive batch entry point (file-selection dialog
or configured paths, per-file analysis, collation). Optional arguments let
non-interactive callers pass paths and a settings file directly:

    python -m ysmr_tpu_torch [--settings tracking.ini] [--result-folder DIR]
                             [--serial] [--device {cuda,cpu}]
                             [video_or_csv ...]

``--device cpu`` runs the plain PyTorch path on the CPU; the default,
``cuda``, raises without a GPU.
"""

import argparse
import sys


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='ysmr_tpu_torch',
        description='Bacterial video tracking and analysis on a CUDA GPU.')
    parser.add_argument('paths', nargs='*', default=None,
                        help='video or .csv files to analyse; when omitted, '
                             'a file-selection dialog is used')
    parser.add_argument('--settings', default=None,
                        help='path to tracking.ini (created with defaults '
                             'when missing)')
    parser.add_argument('--result-folder', default=None,
                        help='output folder (default: dated folder next to '
                             'the first input)')
    parser.add_argument('--serial', action='store_true',
                        help='disable the per-file process pool')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="device of stage 1 (default 'cuda'; 'cpu' runs "
                             'the plain PyTorch path)')
    args = parser.parse_args(argv)
    from ysmr_tpu_torch.main import ysmr
    result = ysmr(paths=args.paths or None, settings=args.settings,
                  result_folder=args.result_folder,
                  multiprocess=not args.serial, device=args.device)
    if result is None:
        return 1
    # nonzero exit when any file failed (result is [(path, df-or-None), ...])
    return 0 if all(res is not None for _, res in result) else 1


if __name__ == '__main__':
    sys.exit(cli())
