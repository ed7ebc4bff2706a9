"""The port imports torch and never jax or ysmr_tpu, not even transitively;
neither does chip_smoke.py; and the package imports without matplotlib
(the H100 machine has none), which is imported only when a plot is drawn."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = '''
import sys
import ysmr_tpu_torch
from ysmr_tpu_torch.pipeline.track_bacteria import _track_loop, track_bacteria
from ysmr_tpu_torch.ops import run_cc, run_prop, ds, labeling, hull, sweep
from ysmr_tpu_torch.ops import assign, assignment, cv2_centers, gsff
from ysmr_tpu_torch.ops import cc, luminosity, preprocess
from ysmr_tpu_torch.pipeline import tracker
from ysmr_tpu_torch.pipeline import detect, detect_pixels
from ysmr_tpu_torch.io import preproc, video
from ysmr_tpu_torch.utils import csv_io, files, logging_utils, xlsx
from ysmr_tpu_torch import config, native, _build
from ysmr_tpu_torch import main, plot_functions, __main__
from ysmr_tpu_torch.pipeline import annotate, display, evaluate, select
from ysmr_tpu_torch.parallel import multi_video, sharding
from ysmr_tpu_torch import graft_entry
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'ysmr_tpu'))
print(bad)
raise SystemExit(1 if bad else 0)
'''


def test_port_imports_no_jax_and_no_ysmr_tpu():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_have_no_jax_imports():
    import re
    pat = re.compile(r'^\s*(import|from) (jax|ysmr_tpu)\b', re.M)
    pkg = os.path.join(REPO, 'ysmr_tpu_torch')
    hits = []
    for root, _, names in os.walk(pkg):
        for name in names:
            if name.endswith('.py'):
                with open(os.path.join(root, name)) as f:
                    hits += ['{}: {}'.format(name, m.group(0))
                             for m in pat.finditer(f.read())]
    assert not hits, hits


_NO_MATPLOTLIB = '''
import sys
sys.modules['matplotlib'] = None        # any import of it raises
sys.modules['seaborn'] = None
import ysmr_tpu_torch
import ysmr_tpu_torch.main
from ysmr_tpu_torch import violin_plot
import pandas as pd
try:
    violin_plot(pd.DataFrame({'a': [1.0], 'b': ['x']}), 'x.png', 'a', 'b',
                [(0, 1, 'x')])
except ImportError:
    print('plot raised ImportError')
else:
    raise SystemExit('a plot without matplotlib did not raise')
assert not [m for m in sys.modules if m.startswith('matplotlib.')]
'''


def test_port_imports_without_matplotlib():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', _NO_MATPLOTLIB], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'plot raised ImportError' in proc.stdout


def test_chip_smoke_imports_no_jax_and_no_ysmr_tpu():
    import re
    pat = re.compile(r'^\s*(import|from) (jax|ysmr_tpu)\b', re.M)
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        hits = [m.group(0) for m in pat.finditer(f.read())]
    assert not hits, hits
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO
    check = _CHECK.replace('import ysmr_tpu_torch\n',
                           'import ysmr_tpu_torch\nimport chip_smoke\n', 1)
    proc = subprocess.run([sys.executable, '-c', check], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
