# Copied from ysmr_tpu/utils/files.py; only the import lines differ.
#!/usr/bin/env python3
"""File discovery, results folders, and the _meta.json sidecar.

Capability parity with the reference (helper_file.py:377-436 results folders /
creation dates, :439-516 ``find_paths``, :519-583 ``get_any_paths``,
:1239-1333 ``make_dir``/``metadata_file``): dated ``YYMMDD_Results/`` folders,
recursive file discovery with age filters, an optional Tk file dialog, and the
``_meta.json`` sidecar that carries fps/frame dimensions between pipeline
stages so each stage can restart from CSV alone. The artifact contracts
(folder naming, sidecar filename derivation, age-window semantics) match the
reference; the internals are this package's own.
"""

import json
import logging
import os
from datetime import datetime
from glob import glob
from time import localtime, strftime

import numpy as np

#: stage-CSV suffixes whose sidecar lives next to the ORIGINAL input file:
#: ``movie_list.csv`` and friends all map to ``movie_meta.json``
_STAGE_SUFFIXES = ('_analysed.csv', '_list.csv', '_selected_data.csv',
                   '_statistics.csv')
_META_SUFFIX = '_meta.json'


def _log():
    return logging.getLogger('ysmr').getChild(__name__)


def make_dir(new_directory):
    """Create a directory tree; silently succeed if it already exists."""
    if os.path.isfile(new_directory):
        raise OSError("cannot create directory '{}': a file by that name "
                      'exists'.format(new_directory))
    os.makedirs(new_directory, exist_ok=True)


def create_results_folder(path):
    """Create a dated result folder next to ``path`` (YYMMDD_Results/)."""
    logger = _log()
    if isinstance(path, (list, tuple)):
        path = path[0] if path else None
    if not isinstance(path, (str, os.PathLike)):
        path = './'
        logger.critical('No usable base path for the results folder; '
                        'falling back to %s', os.path.abspath(path))
    stamp = strftime('%y%m%d', localtime())
    directory = os.path.abspath(os.path.join(
        os.path.dirname(path), '{}_Results/'.format(stamp)))
    if os.path.exists(directory):
        return directory
    try:
        make_dir(directory)
        logger.info('Results folder: %s', directory)
    except OSError as mk_err:
        logger.exception(mk_err)
        directory = './'
        logger.warning('Results folder could not be created; writing '
                       'to %s instead', os.path.abspath(directory))
    return directory


def creation_date(path_to_file):
    """Age of a file in seconds (negative for timestamps in the future).

    Windows exposes a true creation time via ``getctime``; elsewhere the
    birth time is used when the filesystem records it, otherwise the
    modification time (ctime on Linux is metadata-change, not creation).
    """
    if not os.path.isfile(path_to_file):
        return None
    if os.name == 'nt':
        born = os.path.getctime(path_to_file)
    else:
        st = os.stat(path_to_file)
        born = getattr(st, 'st_birthtime', st.st_mtime)
    return (datetime.now() - datetime.fromtimestamp(born)).total_seconds()


def elapsed_time(time_one):
    """Time difference between ``time_one`` and now (None on bad input)."""
    try:
        return datetime.now() - time_one
    except (ValueError, TypeError) as val_error:
        _log().exception(val_error)
        return None


def find_paths(base_path, extension, minimal_age=0, maximal_age=np.inf,
               recursive=True):
    """Files under ``base_path`` matching ``extension``, filtered by age.

    The age window is ``minimal_age <= age <= maximal_age`` in seconds.
    Files whose timestamp lies in the future (negative age) are skipped
    with a warning unless ``minimal_age`` is itself negative, in which
    case they are accepted unconditionally — the reference's semantics
    for clock-skewed network shares (helper_file.py:476-516).
    """
    logger = _log()
    root = str(base_path)
    if not os.path.exists(root):
        logger.warning('Search path does not exist: %s', root)
        return None
    if not root.endswith('/'):
        root += '/'
    pattern = '{}{}*{}'.format(root, '**/' if recursive else '', extension)
    accept_future = minimal_age < 0
    hits = []
    for hit in glob(pattern, recursive=recursive):
        hit = hit.replace(os.sep, '/')
        age = creation_date(hit)
        if age is None:
            continue
        if age < 0:
            if accept_future:
                hits.append(hit)
            else:
                logger.warning('Skipping %s: timestamp is %.2f s in the '
                               'future', hit, -age)
        elif minimal_age <= age <= maximal_age:
            hits.append(hit)
    return hits


def get_any_paths(prev_dir=None, rename=False, file_types=None, settings=None):
    """Ask the user for files via a Tk dialog (interactive sessions only).

    Reference behaviour (helper_file.py:519-583): the starting directory is
    remembered in the tracking ini's ``[HOUSEKEEPING]`` section when
    ``rename`` is set. Returns None in headless environments where tkinter
    cannot open a display.
    """
    logger = _log()
    from ysmr_tpu_torch.config import get_configs
    conf = get_configs(settings)
    try:
        from tkinter import Tk, filedialog
    except ImportError:
        logger.exception('tkinter is unavailable; pass file paths '
                         'explicitly instead.')
        return None
    import configparser
    parser = configparser.ConfigParser(allow_no_value=True)
    if conf:
        parser.read(conf['tracking_ini_filepath'])
    if prev_dir is None:
        try:
            prev_dir = parser['HOUSEKEEPING'].get('previous directory',
                                                  fallback='./')
        except (configparser.Error, KeyError):
            prev_dir = './'
    if file_types is None:
        file_types = [('all files', '.*'), ('csv', '.csv'), ('avi', '.avi'),
                      ('mkv', '.mkv'), ('mov', '.mov'), ('mp4', '.mp4')]
    try:
        tk_root = Tk()
        tk_root.overrideredirect(1)
        tk_root.withdraw()
        chosen = filedialog.askopenfilenames(
            title='Choose files. ', filetypes=file_types,
            defaultextension=file_types[0][1], multiple=True,
            initialdir=prev_dir)
    except Exception as dialog_err:
        logger.exception('File dialog failed (%s): %r',
                         type(dialog_err).__name__, dialog_err.args)
        return None
    if chosen and rename and conf:
        new_prev = os.path.dirname(chosen[0])
        try:
            parser.set('HOUSEKEEPING', 'previous directory', new_prev)
            with open(conf['tracking_ini_filepath'], 'w') as ini_fh:
                parser.write(ini_fh)
            logger.debug('Previous directory set to %s', new_prev)
        except Exception:
            pass
    return chosen


def _sidecar_path(any_path):
    """``_meta.json`` filename for an input file or any of its stage CSVs."""
    for suffix in _STAGE_SUFFIXES:
        if any_path.endswith(suffix):
            return any_path[:-len(suffix)] + _META_SUFFIX
    if any_path.endswith(_META_SUFFIX):
        return any_path
    return os.path.splitext(any_path)[0] + _META_SUFFIX


def metadata_file(path=None, verbose=False, additional_search_paths=None,
                  **kwargs):
    """Read/update the per-input ``_meta.json`` sidecar.

    The sidecar is looked for next to ``path`` first, then one directory
    level up (stage CSVs live in ``YYMMDD_Results/`` below the input
    video), then under any ``additional_search_paths``. None values are
    stripped on read and write; fresh kwargs override file contents
    (helper_file.py:1267-1333). Returns the merged dict.
    """
    logger = _log()
    folder, file_name = os.path.split(path)
    one_level_up = os.path.join(os.path.dirname(folder), file_name)
    extra = additional_search_paths or []
    if isinstance(extra, (str, os.PathLike)):
        extra = [extra]
    candidates = [_sidecar_path(p)
                  for p in [path, one_level_up, *extra]]

    meta_data = {}
    save_path = candidates[0]
    for candidate in candidates:
        if verbose:
            logger.debug('Searching for meta file in path: %s', candidate)
        try:
            with open(candidate, 'r') as meta_fh:
                on_disk = json.load(meta_fh)
        except (FileNotFoundError, PermissionError, ValueError):
            continue
        meta_data.update(
            {k: v for k, v in on_disk.items() if v is not None})
        save_path = candidate
        break

    fresh = {k: v for k, v in kwargs.items() if v is not None}
    if fresh:
        meta_data.update(fresh)
        try:
            with open(save_path, 'w+') as meta_fh:
                json.dump(meta_data, meta_fh)
        except (FileNotFoundError, PermissionError) as write_err:
            logger.exception(write_err)
    return meta_data
