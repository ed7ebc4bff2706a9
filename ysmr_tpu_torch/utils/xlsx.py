# Copied from ysmr_tpu/utils/xlsx.py; only the import lines differ.
#!/usr/bin/env python3
"""Minimal dependency-free .xlsx writer (stdlib zipfile + XML).

The reference delegates XLSX collation to the optional ``xlsxwriter`` package
(helper_file.py:92-140). That package is not available in this environment,
so this module implements the small subset needed: a multi-sheet workbook
with inline strings and numbers. Output opens in Excel/LibreOffice/pandas.
"""

import re
from xml.sax.saxutils import escape
from zipfile import ZIP_DEFLATED, ZipFile

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" '
    'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '{sheets}'
    '</Types>'
)

_SHEET_CONTENT_TYPE = (
    '<Override PartName="/xl/worksheets/sheet{idx}.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
)

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    '</Relationships>'
)

_ILLEGAL_SHEET_CHARS = re.compile(r'[\\/*?:\[\]]')


def _column_name(index):
    """0-based column index -> spreadsheet column letters (0 -> 'A')."""
    name = ''
    index += 1
    while index:
        index, rem = divmod(index - 1, 26)
        name = chr(ord('A') + rem) + name
    return name


def _cell_xml(ref, value):
    if value is None:
        return ''
    if isinstance(value, bool):
        return '<c r="{}" t="b"><v>{}</v></c>'.format(ref, int(value))
    if isinstance(value, (int, float)):
        if value != value or value in (float('inf'), float('-inf')):  # NaN/inf
            return '<c r="{}" t="inlineStr"><is><t>{}</t></is></c>'.format(ref, value)
        if isinstance(value, float):
            return '<c r="{}"><v>{!r}</v></c>'.format(ref, float(value))
        return '<c r="{}"><v>{}</v></c>'.format(ref, int(value))
    text = escape(str(value))
    return '<c r="{}" t="inlineStr"><is><t>{}</t></is></c>'.format(ref, text)


def _sheet_xml(rows):
    parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>']
    for r_idx, row in enumerate(rows, start=1):
        cells = ''.join(_cell_xml('{}{}'.format(_column_name(c_idx), r_idx), val)
                        for c_idx, val in enumerate(row))
        parts.append('<row r="{}">{}</row>'.format(r_idx, cells))
    parts.append('</sheetData></worksheet>')
    return ''.join(parts)


def sanitize_sheet_name(name, used=None, limit=31):
    """Clamp to 31 chars and strip characters Excel forbids; dedupe."""
    name = _ILLEGAL_SHEET_CHARS.sub('_', str(name))[:limit] or 'Sheet'
    if used is not None:
        base, n = name, 1
        while name.lower() in used:
            suffix = '_{}'.format(n)
            name = base[:limit - len(suffix)] + suffix
            n += 1
        used.add(name.lower())
    return name


def write_xlsx(path, sheets):
    """Write an .xlsx workbook.

    :param path: output file path
    :param sheets: list of (sheet_name, rows) where rows is an iterable of
        lists of cell values (str/int/float/bool/None)
    """
    used_names = set()
    norm_sheets = [(sanitize_sheet_name(name, used_names), rows) for name, rows in sheets]
    with ZipFile(path, 'w', ZIP_DEFLATED) as zf:
        zf.writestr('[Content_Types].xml', _CONTENT_TYPES.format(
            sheets=''.join(_SHEET_CONTENT_TYPE.format(idx=i + 1)
                           for i in range(len(norm_sheets)))))
        zf.writestr('_rels/.rels', _ROOT_RELS)
        sheet_tags = ''.join(
            '<sheet name="{}" sheetId="{}" r:id="rId{}"/>'.format(
                escape(name), i + 1, i + 1)
            for i, (name, _) in enumerate(norm_sheets))
        zf.writestr('xl/workbook.xml', (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
            '<sheets>{}</sheets></workbook>'.format(sheet_tags)))
        rels = ''.join(
            '<Relationship Id="rId{0}" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/worksheet" '
            'Target="worksheets/sheet{0}.xml"/>'.format(i + 1)
            for i in range(len(norm_sheets)))
        zf.writestr('xl/_rels/workbook.xml.rels', (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
            'relationships">{}</Relationships>'.format(rels)))
        for i, (name, rows) in enumerate(norm_sheets):
            zf.writestr('xl/worksheets/sheet{}.xml'.format(i + 1), _sheet_xml(rows))


def dataframe_to_rows(df, include_index=True):
    """Convert a pandas DataFrame to xlsx rows (header + values)."""
    header = ([''] if include_index else []) + [str(c) for c in df.columns]
    rows = [header]
    for idx, row in zip(df.index, df.itertuples(index=False, name=None)):
        base = [idx] if include_index else []
        rows.append(base + [None if v != v else v
                            if isinstance(v, (int, float, bool)) else str(v)
                            for v in row])
    return rows
