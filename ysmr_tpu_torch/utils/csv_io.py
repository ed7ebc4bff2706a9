# Copied from ysmr_tpu/utils/csv_io.py; only the import lines differ.
#!/usr/bin/env python3
"""CSV interchange: the _list/_selected_data/_statistics/_analysed artifacts.

Capability parity with the reference result-CSV layer (helper_file.py:846-919
``get_data``, :1366-1400 ``save_df_to_csv``, :1403-1478 ``save_list``,
:1538-1574 ``sort_list``, :439-457 ``different_tracks``, :92-140 xlsx
collation, :71-89 ``bytes_to_human_readable``). The canonical schema is
``TRACK_ID, POSITION_T, POSITION_X, POSITION_Y, WIDTH, HEIGHT, DEGREES_ANGLE
[, ILLUMINATION]``.

The hot append path (``save_list``) accepts either the reference's
row-tuple format or packed numpy arrays straight from the device pipeline;
the numpy path formats whole columns at once and is what track_bacteria uses.
A C++ fast formatter (native/ysmr_native.cpp) is used when built.
"""

import logging
import os
from datetime import datetime

import numpy as np
import pandas as pd

from ysmr_tpu_torch.utils.files import find_paths, get_any_paths

CSV_HEADER = 'TRACK_ID,POSITION_T,POSITION_X,POSITION_Y,WIDTH,HEIGHT,DEGREES_ANGLE'
CSV_HEADER_ILLUMINATION = CSV_HEADER + ',ILLUMINATION'

DEFAULT_DTYPE = {
    'TRACK_ID': np.uint32,
    'POSITION_T': np.uint32,
    'POSITION_X': np.float64,
    'POSITION_Y': np.float64,
    'WIDTH': np.float64,
    'HEIGHT': np.float64,
    'DEGREES_ANGLE': np.float64,
}


def bytes_to_human_readable(number_of_bytes):
    """Bytes as a rounded string with SI-style binary unit prefix."""
    if number_of_bytes < 0:
        return 'Negative Bytes'
    units = ['bytes', 'KB', 'MB', 'GB', 'TB', 'PB', 'EB', 'ZB', 'YB']
    for unit in units:
        if number_of_bytes / 1024 < 1 or unit == units[-1]:
            break
        number_of_bytes /= 1024
    return '{0:.01f} {1}'.format(number_of_bytes, unit)


def different_tracks(data, column='TRACK_ID'):
    """Start/stop indices of runs of equal values in ``column``.

    Returns ([starts], [stops]) exactly as the reference does
    (helper_file.py:439-457); downstream selection logic depends on this
    contract.
    """
    track_id = np.asarray(data[column])
    index = data.index[:-1].to_numpy()
    stops = index[track_id[:-1] != track_id[1:]].tolist()
    starts = [int(data.index.min())]
    starts.extend([item + 1 for item in stops])
    stops.append(int(data.index.max()))
    return starts, stops


def get_data(csv_file_path, dtype=None, check_sorted=True):
    """Load a result CSV into a typed DataFrame; sort heuristic as reference."""
    logger = logging.getLogger('ysmr').getChild(__name__)
    if isinstance(csv_file_path, (list, tuple)):
        csv_file_path = csv_file_path[0]
        logger.warning('Passed list or tuple argument to get_data(); '
                       'only first element used.')
    try:
        file_size = bytes_to_human_readable(os.path.getsize(csv_file_path))
        logger.info('Reading file with size %s: %s', file_size, csv_file_path)
    except (ValueError, TypeError, OSError):
        pass
    if dtype is None:
        dtype = DEFAULT_DTYPE
    use_cols = list(dtype.keys())
    try:
        with open(csv_file_path, 'r', newline='\n') as csv:
            df = pd.read_csv(csv, sep=',', header=0, usecols=use_cols, dtype=dtype)
    except ValueError as val_error:
        logger.exception('Invalid file %s: %s', csv_file_path, val_error)
        return None
    except OSError as os_error:
        logger.exception(os_error)
        return None
    # Heuristic sortedness check: if the first six TRACK_IDs are unique the
    # frame is presumed frame-major and is re-sorted (helper_file.py:909-917).
    if check_sorted and all(x in use_cols for x in ['TRACK_ID', 'POSITION_T']):
        if df.loc[:5, 'TRACK_ID'].is_unique:
            logger.info('Data frame seems unsorted by TRACK_ID/POSITION_T; sorting now.')
            df = sort_list(df=df, save_file=False)
            if df is None:
                return None
    logger.debug('Done reading %s into data frame', csv_file_path)
    return df


def sort_list(file_path=None, sort=None, df=None, save_file=False):
    """Sort by [TRACK_ID, POSITION_T]; optionally load from/save to CSV."""
    logger = logging.getLogger('ysmr').getChild(__name__)
    if sort is None:
        sort = ['TRACK_ID', 'POSITION_T']
    elif isinstance(sort, (str, bytes)):
        sort = [sort]
    if file_path is not None and df is None:
        df = get_data(file_path, check_sorted=False)
    if df is None:
        logger.warning('No Dataframe read')
        return None
    try:
        df.sort_values(by=sort, inplace=True, na_position='first', kind='stable')
        df.reset_index(drop=True, inplace=True)
        logger.debug('Sorted data frame by %s.', sort[0])
    except Exception as ex:
        logger.exception('An exception of type %s occurred while sorting file %s. '
                         'Arguments: %r', type(ex).__name__, file_path, ex.args)
        return None
    if save_file and file_path is not None:
        save_df_to_csv(df=df, save_path=file_path, rename_old_file=False)
    elif save_file:
        logger.critical('Cannot save file if no file path is provided.')
    return df


_CSV_SPECIALS = (',', '"', '\n', '\r')


def _fast_df_csv_bytes(df):
    """pandas-identical ``to_csv(index=False)`` bytes via the native typed
    formatter, or None when a column needs pandas (float32, exotic dtypes,
    strings containing characters pandas would quote).

    pandas spends seconds per million rows in per-chunk object conversion;
    the native path renders the same bytes (tests/test_csv_io.py asserts
    byte equality) in one pass — the dominant cost of the dense-scene
    select/evaluate stages was this serialisation.
    """
    from ysmr_tpu_torch import native
    if not native.available():
        return None
    for name in df.columns:
        if not isinstance(name, str) or any(c in name for c in _CSV_SPECIALS):
            return None
    columns = []
    for name in df.columns:
        arr = df[name].to_numpy()
        kind = arr.dtype.kind
        if kind in 'iu':
            columns.append((native.TABLE_INT64, arr))
        elif kind == 'f':
            if arr.dtype == np.float64:
                columns.append((native.TABLE_FLOAT64, arr))
            elif arr.dtype == np.float16:
                columns.append((native.TABLE_FLOAT16, arr))
            else:
                return None
        elif kind == 'b':
            columns.append((native.TABLE_BOOL, arr))
        elif kind in 'OU':
            try:
                vals = arr.astype('U')
            except (TypeError, ValueError):
                return None
            if kind == 'O' and not all(isinstance(v, str) for v in arr):
                return None
            joined = '' if vals.size == 0 else ''.join(
                np.unique(vals).tolist())
            if any(c in joined for c in _CSV_SPECIALS):
                return None
            if vals.size and (np.char.str_len(vals) == 0).any():
                return None  # pandas renders empty strings as ""
            columns.append((native.TABLE_BYTES, np.char.encode(vals, 'utf-8')))
        else:
            return None
    if len(columns) == 1 and columns[0][0] in (native.TABLE_FLOAT64,
                                               native.TABLE_FLOAT16):
        if np.isnan(np.asarray(columns[0][1], dtype=np.float64)).any():
            return None  # pandas quotes a fully-empty row ("")
    header = (','.join(df.columns) + '\n').encode('utf-8')
    body = native.format_table(columns)
    if body is None:
        return None
    return header + body


def save_df_to_csv(df, save_path, rename_old_file=True):
    """Save a DataFrame to CSV, optionally renaming a pre-existing file."""
    logger = logging.getLogger('ysmr').getChild(__name__)
    if rename_old_file:
        try:
            old_dir, old_name = os.path.split(save_path)
            old_csv = os.path.join(old_dir, '{}.{}'.format(
                datetime.now().strftime('%y%m%d%H%M%S'), old_name))
            os.rename(save_path, old_csv)
            logger.critical('Old %s renamed to %s', os.path.basename(save_path), old_csv)
        except (FileNotFoundError, FileExistsError):
            pass
        except Exception as ex:
            logger.exception('Error renaming previous file %s: %r', save_path, ex.args)
    try:
        fast = _fast_df_csv_bytes(df)
        if fast is not None:
            with open(save_path, 'wb') as out:
                out.write(fast)
        else:
            with open(save_path, 'w+', newline='\n') as csv:
                df.to_csv(csv, index=False, encoding='utf-8')
        logger.debug('Selected results saved to: %s', save_path)
    except Exception as ex:
        logger.exception('Error saving file %s: %r', save_path, ex.args)


def _format_rows_numpy(track_id, frame, x, y, w, h, deg, illumination=None):
    """Vectorised CSV row formatting for packed result columns.

    Returns a bytes-like object (native path: a memoryview over the C
    formatter's output buffer — no str decode/encode round trip) or ``str``
    from the numpy fallback; writers open in binary and encode str lazily.
    """
    try:
        from ysmr_tpu_torch.native import format_rows_bytes as native_format
    except Exception:
        native_format = None
    if native_format is not None:
        raw = native_format(track_id, frame, x, y, w, h, deg, illumination)
        if raw is not None:
            return raw
    cols = [np.char.mod('%d', track_id.astype(np.int64)),
            np.char.mod('%d', frame.astype(np.int64))]
    for arr in (x, y, w, h, deg):
        cols.append(np.char.mod('%s', arr.astype(np.float64)))
    if illumination is not None:
        cols.append(np.char.mod('%s', illumination.astype(np.float64)))
    joined = cols[0]
    for col in cols[1:]:
        joined = np.char.add(np.char.add(joined, ','), col)
    return '\n'.join(joined.tolist()) + '\n'


def save_list(path, result_folder=None, coords=None, first_call=False,
              rename_old_list=True, illumination=False, arrays=None):
    """Create/append the ``_list.csv`` tracker output.

    First call sets up the file (rename/overwrite semantics of
    helper_file.py:1419-1454) and returns ``(old_list_or_False, csv_path)``.
    Subsequent calls append rows, either from the reference's
    ``(frame, id, centroid, (w, h, deg))`` tuples via ``coords`` or from
    packed numpy columns via ``arrays`` (dict of column arrays).
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    if first_call:
        pathname_file, filename_ext = os.path.split(path)
        pathname = result_folder if result_folder is not None else pathname_file
        filename = os.path.splitext(filename_ext)[0]
        file_csv = os.path.join(pathname, '{}_list.csv'.format(filename))
        now = datetime.now().strftime('%y%m%d%H%M%S')
        old_list = False
        permission_error = False
        if os.path.isfile(file_csv):
            if rename_old_list:
                old_root, old_ext = os.path.splitext(file_csv)
                old_list = '{}_{}{}'.format(old_root, now, old_ext)
                try:
                    os.rename(file_csv, old_list)
                    logger.info('Renaming old results to %s.', old_list)
                except PermissionError:
                    permission_error = True
            else:
                try:
                    os.remove(file_csv)
                    logger.warning('Overwriting old results without saving: %s', file_csv)
                except PermissionError:
                    permission_error = True
        if permission_error:
            old_list = file_csv
            file_csv = os.path.join(pathname, '{}_{}_list.csv'.format(now, filename))
            logger.warning('Permission to change old csv denied, renamed new one to %s',
                           file_csv)
        with open(file_csv, 'w+', newline='') as file:
            file.write((CSV_HEADER_ILLUMINATION if illumination else CSV_HEADER) + '\n')
        return old_list, file_csv

    if arrays is not None and len(arrays.get('TRACK_ID', ())):
        text = _format_rows_numpy(
            arrays['TRACK_ID'], arrays['POSITION_T'], arrays['POSITION_X'],
            arrays['POSITION_Y'], arrays['WIDTH'], arrays['HEIGHT'],
            arrays['DEGREES_ANGLE'],
            arrays.get('ILLUMINATION') if illumination else None)
        with open(path, 'ab') as file:
            file.write(text.encode('ascii') if isinstance(text, str) else text)
        return None, None

    if coords:
        parts = []
        for frame, obj_id, xy, (w, h, deg) in coords:
            x, y = xy[:2]
            row = '{0},{1},{2},{3},{4},{5},{6}'.format(
                int(obj_id), int(frame), x, y, w, h, deg)
            if illumination:
                row = '{},{}'.format(row, xy[2])
            parts.append(row)
        with open(path, 'a', newline='') as file:
            file.write('\n'.join(parts) + '\n')
    return None, None


def finalize_sorted_list(parts, list_name, illumination=False, save_file=True):
    """Sort accumulated column parts by [TRACK_ID, POSITION_T] and finish
    the ``_list.csv`` artifact without re-reading it from disk.

    Equivalent to ``sort_list(file_path=list_name, save_file=save_file)``
    (reference helper_file.py:1538-1574) when the caller still holds the
    unsorted rows in memory: the sorted CSV is rewritten with the native
    row formatter and the typed DataFrame is built directly.

    :param parts: list of column-array dicts as produced during tracking
    :return: DataFrame with the canonical columns/dtypes, sorted
    """
    if not parts:
        return None
    arrays = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.lexsort((arrays['POSITION_T'], arrays['TRACK_ID']))
    arrays = {k: v[order] for k, v in arrays.items()}
    with_lum = illumination and 'ILLUMINATION' in arrays
    if save_file:
        text = _format_rows_numpy(
            arrays['TRACK_ID'], arrays['POSITION_T'], arrays['POSITION_X'],
            arrays['POSITION_Y'], arrays['WIDTH'], arrays['HEIGHT'],
            arrays['DEGREES_ANGLE'],
            arrays['ILLUMINATION'] if with_lum else None)
        with open(list_name, 'wb') as file:
            header = CSV_HEADER_ILLUMINATION if with_lum else CSV_HEADER
            file.write((header + '\n').encode('ascii'))
            file.write(text.encode('ascii') if isinstance(text, str) else text)
    dtype = dict(DEFAULT_DTYPE)
    if with_lum:
        dtype['ILLUMINATION'] = np.float64
    # the column arrays are freshly built above — hand them to pandas
    # without the defensive astype copy when the dtype already matches
    return pd.DataFrame({k: arrays[k] if arrays[k].dtype == dt
                         else arrays[k].astype(dt)
                         for k, dt in dtype.items()})


def collate_results_csv_to_xlsx(path=None, save_path=None, csv_extension='statistics.csv'):
    """Collect all ``*statistics.csv`` under ``path`` into one .xlsx.

    Uses the built-in minimal xlsx writer (ysmr_tpu.utils.xlsx) instead of the
    reference's optional xlsxwriter dependency; one sheet per file, 31-char
    sheet names, 2^20-row cap (helper_file.py:92-140).
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    from ysmr_tpu_torch.utils.xlsx import dataframe_to_rows, write_xlsx
    if save_path is None:
        save_path = './'
    if path is None:
        path = get_any_paths(rename=False, file_types=[('csv', '.csv'),
                                                       ('all files', '.*')])
    file_path = os.path.join(save_path, '{}_collated_statistics.xlsx'.format(
        datetime.now().strftime('%y%m%d%H%M%S')))
    paths = find_paths(base_path=path, extension=csv_extension)
    if not paths:
        logger.info('Could not find paths.')
        return None
    paths = sorted(paths)
    sheets = []
    for csv_path in paths:
        with open(csv_path, 'r', newline='\n', encoding='utf-8') as csv:
            df = pd.read_csv(csv, sep=',', header=0, encoding='utf-8')
        file_name = os.path.splitext(os.path.basename(csv_path))[0]
        sheets.append((file_name[:31], dataframe_to_rows(df.loc[:2 ** 20 - 1, :])))
    write_xlsx(file_path, sheets)
    logger.info('Collated results: %s', os.path.abspath(file_path))
    return file_path
