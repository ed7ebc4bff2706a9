# Copied from ysmr_tpu/config.py; the import lines differ, and comments
# that quoted timings of the TPU round or described the JAX package.
#!/usr/bin/env python3
"""tracking.ini configuration system for ysmr_tpu.

Public interchange format parity with the reference (helper_file.py:143-315
``create_configs`` and :586-843 ``get_configs``): the same eleven sections and
key strings, the same derived-value semantics (log-level mapping, rod/coccoid
width-height-ratio preset collapse, percent-to-fraction conversions, the
``maximal empty frames in %`` -> ``x/100 + 1`` duration/size bound, colour
filter resolution), the same flat-dict settings object keyed by the literal
ini option strings, and the same regenerate-on-broken behaviour.

New in this build: a ``[TPU SETTINGS]`` section controlling device-side
batching, padded table capacities, and kernel selection. It is read with
fallbacks so reference-era tracking.ini files keep working unchanged.
"""

import configparser
import logging
import os
import subprocess
import sys
from datetime import datetime

LOG = logging.getLogger('ysmr').getChild(__name__)

#: Sections in canonical order (reference helper_file.py:160-282).
_TPU_SECTION = 'TPU SETTINGS'

_TPU_DEFAULTS = {
    # capacities sized for the reference use case ("several hundred objects",
    # README.md:419); padded shapes cost compute on every frame, so defaults
    # stay close to that scale — raise for denser scenes
    'frame batch size': 16,
    'max detections per frame': 512,
    'max track slots': 1024,
    'connected components max iterations': 64,
    # read and kept for tracking.ini compatibility; the port uses it
    # nowhere (its kernels are CUDA and always on)
    'use pallas kernels': True,
    # parallel decode workers (whole batches interleaved over threads, each
    # worker with its own capture/demux handle — io/video.py). Clamped to the
    # host's CPU count; gated to MJPG input and non-mean threshold modes,
    # where it is byte-identical to sequential decode (tests/
    # test_striped_decode.py). On a single-core host this resolves to one
    # decode thread, which still pays off by filling device-wait windows
    # (readback/tunnel latency) with decode work; 0 opts into inline
    # (threadless) decode.
    'host decode threads': 2,
    'prefetch batches': 3,
    # 'frames' (raw frames to device, full detection on device) or 'pixels'
    # (host thresholding, compact foreground tables to device); 'auto'
    # picks pixels: the port does not probe the link
    # (pipeline/track_bacteria.py::resolve_transfer_mode)
    'transfer mode': 'auto',
    # 'exact' decodes via cv2.VideoCapture and converts BGR->gray with the
    # bit-exact OpenCV recipe (same pixels as the reference); 'fast' demuxes
    # MJPG AVIs and decodes JPEG luma directly to grayscale (gray values
    # within +-2 of exact, detections unchanged in practice — see
    # io/video.py MjpgAviDemuxer; its saving is not measured on the H100
    # machine)
    'decode mode': 'exact',
    'max foreground pixels per frame': 8192,
    # caps the per-row hull-candidate table; components taller than this are
    # measured from a truncated hull (harmless for bacteria-scale blobs)
    'max bounding box height': 96,
    # side of the per-detection window used for the reference-exact rotated-
    # rect luminosity mean (ops/luminosity.py); rectangles larger than this
    # are averaged over the truncated window
    'luminosity window size': 48,
    # measure (cx, cy, w, h, angle) on the host with the bit-exact replica of
    # cv2's contour->hull->minAreaRect chain (native/cv2_exact.cpp) instead of
    # the device hull/caliper kernel. Reference-identical measurements to the
    # last float bit — this is what makes TRACK_ID numbering match the
    # reference exactly (the device rects differ from cv2 by its ~3e-4 px f32
    # caliper noise, which the filter amplifies at mode transitions). Applies
    # in pixels transfer mode when the native library is built; the device
    # path is used otherwise.
    'cv2 exact rects': True,
    # capacity gate for the host path above: scenes whose 'max detections
    # per frame' exceeds this keep the device tracker (the host rect trace
    # + float64 tracker run on one core). Raise it to opt dense scenes
    # into the bit-exact path.
    'cv2 exact rects max detections': 1024,
    # when the host-rect path is OFF, compute cv2's f32 caliper CENTER
    # bit-exactly on device (ops/cv2_centers.py) and feed the tracker that
    # instead of the exact-arithmetic center: the measurement stream then
    # matches the reference's, leaving only the double-single GSFF residue
    # as an id-parity deviation. On the GPU one launch of
    # csrc/cv2_centers.cu a batch: 0.17 ms of device time for 64 frames of
    # 4096 detections on an NVIDIA H100 80GB HBM3 at 700 W
    # (trace_kernels.py); 'off' keeps the exact-arithmetic centers.
    'cv2 exact centers': 'auto',
    # host->device wire for pixels mode: 'auto' run-length-encodes the
    # foreground pixels (raster-order blobs are horizontal runs; ~4-5x
    # less traffic at dense scale, expanded back on device), 'pixels'
    # ships one word per pixel. 'runs' forces RLE where 'auto' would.
    'wire format': 'auto',
    # labeling representation when the runs wire is active: 'auto' and 'on'
    # run connected components directly on the (T, R) run tables on every
    # device (ops/run_cc.py — no whole-frame raster or pixel-table sort;
    # pipeline/track_bacteria.py), 'off' keeps the pixel-table labeling
    'run cc': 'auto',
    # pack live tracker emissions into one buffer on device before readback
    # (tracker.compact_emissions_device). Meant for links where the
    # device-to-host direction is contended; on the H100 machine it
    # measured no gain at 4096 slots (PERF.md, chip_smoke.py phase 20), so
    # the default is off.
    'compact emissions readback': False,
    # log per-frame wait/dispatch/readback stage times at the end of a run
    'profile stages': False,
    # write a device trace of each tracking run into this directory (the
    # JAX package: a jax.profiler trace; this port: a torch.profiler Chrome
    # trace); empty = disabled
    'jax profiler dir': '',
    # opt-in sparse O(F log F) connected components (see ops/labeling.py
    # label_components_table; loses to the whole-frame stencil end-to-end)
    'use table cc': False,
    # shard a batch of videos over the device mesh (parallel/multi_video.py)
    # instead of dispatching one OS process per file: every device runs the
    # fused detect+track on its own videos, per-video state carried across
    # frame batches, per-video _list.csv outputs identical to solo runs.
    # Falls back to solo tracking for mean-threshold mode (sequential host
    # state) and for .csv restarts.
    'shard videos across devices': False,
    # dense-scene assignment sharding (parallel/sharding.py
    # sharded_row_min_argmin): row-shard the tracker's slots x detections
    # distance matrix over the device mesh — each device searches its row
    # block, only O(rows) min/argmin vectors cross the interconnect. Takes
    # effect when enabled AND more than one device is visible AND
    # max track slots x max detections per frame reaches the threshold
    # below (smaller matrices fit one chip; the collective would be pure
    # overhead). Slot count must divide evenly over the mesh.
    'shard dense assignment across devices': False,
    'dense assignment shard threshold': 1 << 21,
}


def default_config_dict():
    """Default configuration values, one dict per section.

    Values mirror the reference defaults (helper_file.py:160-282) so a file
    generated by either implementation parses identically in both.
    """
    return {
        'BASIC RECORDING SETTINGS': {
            'pixel per micrometre': 1.41888781,
            'frames per second': 30.0,
            'frame height': 922,
            'frame width': 1228,
            'white bacteria on dark background': True,
            'rod shaped bacteria': True,
            'threshold offset for detection': 5,
        },
        'BASIC TRACK DATA ANALYSIS SETTINGS': {
            'minimal length in seconds': 20.0,
            'limit track length to x seconds': 20.0,
            'minimal angle in degrees for turning point': 30.0,
            'extreme area outliers lower end in px*px': 2,
            'extreme area outliers upper end in px*px': 50,
        },
        'DISPLAY SETTINGS': {
            'user input': True,
            'select files': True,
            'display video analysis': True,
            'save video': False,
        },
        'RESULTS SETTINGS': {
            'rename previous result .csv': False,
            'delete .csv file after analysis': False,
            'store processed .csv file': True,
            'store generated statistical .csv file': True,
            'store final analysed .csv file': True,
            'split results by (Turn Points / Distance / Speed / Time / '
            'Displacement / perc. motile)': 'perc. motile',
            'split violin plots on': '0.0, 20.0, 40.0, 60.0, 80.0, 100.01',
            'save large plots': True,
            'save rose plot': True,
            'save time violin plot': True,
            'save acr violin plot': True,
            'save length violin plot': True,
            'save turning point violin plot': True,
            'save speed violin plot': True,
            'save angle distribution plot / bins': 36,
            'save displacement violin plot': True,
            'save percent motile plot': True,
            'collate results csv to xlsx': True,
        },
        'PLOT Y-AXIS LIMITS': {
            'turning point violin plot min': 0.0,
            'turning point violin plot max': False,
            'length violin plot min': 0.0,
            'length violin plot max': False,
            'speed violin plot min': 0.0,
            'speed violin plot max': False,
            'time violin plot min': 0.0,
            'time violin plot max': False,
            'displacement violin plot min': 0.0,
            'displacement violin plot max': False,
            'percent motile plot min': 0.0,
            'percent motile plot max': 100.0,
            'acr violin plot min': 0.0,
            'acr violin plot max': 1.0,
        },
        'LOGGING SETTINGS': {
            'log to file': True,
            'log file path': './logfile.log',
            'shorten displayed logging output': False,
            'shorten logfile logging output': False,
            'set logging level (debug/info/warning/critical)': 'debug',
            'verbose': False,
        },
        'ADVANCED VIDEO SETTINGS': {
            'include luminosity in tracking calculation': False,
            'color filter': 'COLOR_BGR2GRAY',
            'minimal frame count': 600,
            'stop evaluation on error': True,
            'list save length interval': 10000,
            'save video file extension': '.mp4',
            'save video fourcc codec': 'mp4v',
            'adaptive double threshold': 2.0,
        },
        'ADVANCED TRACK DATA ANALYSIS SETTINGS': {
            'maximal consecutive holes': 5,
            'maximal empty frames in %': 5.0,
            'percent quantiles excluded area': 10.0,
            'try to omit motility outliers': True,
            'stop excluding motility outliers if total count above percent': 5.0,
            'exclude measurement when above x times average area': 1.5,
            'rod average width/height ratio min.': 0.125,
            'rod average width/height ratio max.': 0.67,
            'coccoid average width/height ratio min.': 0.8,
            'coccoid average width/height ratio max.': 1.0,
            'percent of screen edges to exclude': 5.0,
            'maximal recursion depth': 960,
            'limit track length exactly': False,
            'compare angle between n frames': 10,
            'force tracking.ini fps settings': False,
        },
        'GAUSSIAN-SUM FIR FILTER SETTINGS': {
            'disable gsff': False,
            'number of LSFFs': 3,
            'minimum horizon size': 0,
            'maximum horizon size': 30,
        },
        'HOUSEKEEPING': {
            'previous directory': './',
            'shut down after analysis': False,
        },
        'TEST SETTINGS': {
            'debugging': False,
            'path to test video': 'Q:/test_video.avi',
        },
        _TPU_SECTION: dict(_TPU_DEFAULTS),
    }


def create_configs(config_filepath=None, open_editor=None):
    """Generate a tracking.ini with default values.

    Behaviour parity with the reference (helper_file.py:143-315): an existing
    file is renamed with a timestamp suffix, the new file is written, and —
    when running interactively — the file is opened in the OS editor so the
    user can review it. Headless runs (no tty, or ``open_editor=False``) skip
    the editor step instead of blocking.

    :param config_filepath: optional file path; defaults to ./tracking.ini
    :param open_editor: force/suppress opening the file in an editor
    :return: None
    """
    if config_filepath is None:
        config_filepath = os.path.join(os.path.abspath('./'), 'tracking.ini')
    try:
        root, ext = os.path.splitext(config_filepath)
        old_name = '{}_{}{}'.format(root, datetime.now().strftime('%y%m%d%H%M%S'), ext)
        os.rename(config_filepath, old_name)
        LOG.warning('Old tracking.ini renamed to %s', old_name)
    except FileNotFoundError:
        pass

    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in default_config_dict().items():
        parser[section] = {key: str(val) for key, val in values.items()}
    try:
        with open(config_filepath, 'w+') as configfile:
            parser.write(configfile)
        LOG.critical('tracking.ini was reset to default values. Path: %s', config_filepath)
    except (IOError, OSError) as write_error:
        LOG.exception('Could not create config file: %s', write_error)
        return

    if open_editor is None:
        open_editor = sys.stdin.isatty() and os.environ.get('YSMR_NO_EDITOR', '') == ''
    if open_editor:
        try:
            if os.name == 'nt':
                subprocess.run('cmd /c start "" "{}"'.format(config_filepath),
                               stderr=subprocess.PIPE)
            elif sys.platform.startswith('darwin'):
                subprocess.call(('open', config_filepath), stderr=subprocess.PIPE)
            else:
                subprocess.call(('xdg-open', config_filepath), stderr=subprocess.PIPE)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError) as open_error:
            LOG.exception(open_error)
    LOG.critical('Created new tracking.ini. Please check the values in the file: %s',
                 config_filepath)


def val_to_float_or_false(value):
    """Convert to float; return False when conversion fails.

    Mirrors helper_file.py:364-374 (plot-axis limits accept floats or the
    literal string 'False').
    """
    try:
        return float(value)
    except (TypeError, ValueError):
        return False


def _resolve_colour_filter(name):
    """Resolve a colour-filter name (or int string) to a cv2 conversion flag.

    Reference semantics (helper_file.py:1481-1510) but via ``getattr`` rather
    than ``eval``. Exits on unknown names, as the reference does.
    """
    if isinstance(name, int):
        return name
    if name.isdigit():
        return int(name)
    import cv2
    if name.startswith('COLOR_') and hasattr(cv2, name):
        return getattr(cv2, name)
    LOG.critical('Could not find color_filter %s. Please update tracking.ini '
                 'with a valid cv2 COLOR_* flag name.', name)
    raise SystemExit('Please update tracking.ini accordingly (color filter).')


def get_configs(tracking_ini_filepath=None):
    """Read tracking.ini and return the flat settings dict.

    Accepts a dict (already-built settings pass through unchanged), a path, or
    None (./tracking.ini); missing/broken files are regenerated with defaults
    and None is returned — reference semantics (helper_file.py:586-843).
    """
    if isinstance(tracking_ini_filepath, dict):
        return tracking_ini_filepath

    if tracking_ini_filepath is None:
        tracking_ini_filepath = os.path.join(os.path.abspath('./'), 'tracking.ini')
    tracking_ini_filepath = os.path.abspath(tracking_ini_filepath)
    parser = configparser.ConfigParser(allow_no_value=True)
    parser.read(tracking_ini_filepath)
    settings_dict = None
    try:
        basic_recording = parser['BASIC RECORDING SETTINGS']
        basic_track = parser['BASIC TRACK DATA ANALYSIS SETTINGS']
        display = parser['DISPLAY SETTINGS']
        results = parser['RESULTS SETTINGS']
        y_axis_lim = parser['PLOT Y-AXIS LIMITS']
        log_settings = parser['LOGGING SETTINGS']
        adv_video = parser['ADVANCED VIDEO SETTINGS']
        adv_track = parser['ADVANCED TRACK DATA ANALYSIS SETTINGS']
        gsff = parser['GAUSSIAN-SUM FIR FILTER SETTINGS']
        housekeeping = parser['HOUSEKEEPING']
        test = parser['TEST SETTINGS']

        verbose = log_settings.getboolean('verbose')
        set_log_level = log_settings.get('set logging level (debug/info/warning/critical)')
        log_levels = {'debug': logging.DEBUG, 'info': logging.INFO,
                      'warning': logging.WARNING, 'critical': logging.CRITICAL}
        set_log_level_setting = logging.DEBUG
        if not verbose:
            if set_log_level.lower() in log_levels:
                set_log_level_setting = log_levels[set_log_level.lower()]
            else:
                LOG.warning('Logging level argument %s not recognised; set to debug. '
                            'Accepted: %s', set_log_level, ' '.join(log_levels))

        rod_shaped_bac = basic_recording.getboolean('rod shaped bacteria')
        if rod_shaped_bac:
            min_size_ratio = adv_track.getfloat('rod average width/height ratio min.')
            max_size_ratio = adv_track.getfloat('rod average width/height ratio max.')
        else:
            min_size_ratio = adv_track.getfloat('coccoid average width/height ratio min.')
            max_size_ratio = adv_track.getfloat('coccoid average width/height ratio max.')

        colour_filter = adv_video.get('color filter')
        colour_filter = _resolve_colour_filter(colour_filter)

        split_on_percentage = [float(i.strip())
                               for i in results.get('split violin plots on').split(',')]
        split_results_by = results.get(
            'split results by (Turn Points / Distance / Speed / Time / '
            'Displacement / perc. motile)')
        perc_motile_warning = False
        if (split_results_by.lower() in 'perc. motile') or \
                ('perc. motile' in split_results_by.lower()):
            if max(split_on_percentage) == 100:
                perc_motile_warning = [
                    'Violin plots are set to \'perc. motile\', but \'split violin plots '
                    'on\' highest value is 100. Lower limits are inclusive, upper limits '
                    'exclusive; consider setting the highest limit to 100.001 to include '
                    'values at 100 %.']

        gsff_max_size = gsff.get('maximum horizon size')
        try:
            gsff_max_size = int(gsff_max_size)
            if not gsff_max_size > 0:
                gsff_max_size = None
        except ValueError:
            gsff_max_size = None

        if parser.has_section(_TPU_SECTION):
            tpu = parser[_TPU_SECTION]
        else:  # reference-era ini files lack this section; use defaults
            tpu = {}

        def tpu_int(key):
            default = _TPU_DEFAULTS[key]
            try:
                return int(tpu.get(key, default))
            except (TypeError, ValueError):
                return default

        def tpu_bool(key):
            default = _TPU_DEFAULTS[key]
            val = tpu.get(key, default)
            if isinstance(val, bool):
                return val
            return str(val).strip().lower() in ('1', 'true', 'yes', 'on')

        settings_dict = {
            # BASIC RECORDING SETTINGS
            'pixel per micrometre': basic_recording.getfloat('pixel per micrometre'),
            'frames per second': basic_recording.getfloat('frames per second'),
            'frame height': basic_recording.getint('frame height'),
            'frame width': basic_recording.getint('frame width'),
            'white bacteria on dark background':
                basic_recording.getboolean('white bacteria on dark background'),
            'rod shaped bacteria': rod_shaped_bac,
            'threshold offset for detection':
                basic_recording.getint('threshold offset for detection'),

            # BASIC TRACK DATA ANALYSIS SETTINGS
            'minimal length in seconds': basic_track.getfloat('minimal length in seconds'),
            'limit track length to x seconds':
                basic_track.getfloat('limit track length to x seconds'),
            'minimal angle in degrees for turning point':
                basic_track.getfloat('minimal angle in degrees for turning point'),
            'extreme area outliers lower end in px*px':
                basic_track.getint('extreme area outliers lower end in px*px'),
            'extreme area outliers upper end in px*px':
                basic_track.getint('extreme area outliers upper end in px*px'),

            # DISPLAY SETTINGS
            'user input': display.getboolean('user input'),
            'select files': display.getboolean('select files'),
            'display video analysis': display.getboolean('display video analysis'),
            'save video': display.getboolean('save video'),

            # RESULTS SETTINGS
            'rename previous result .csv': results.getboolean('rename previous result .csv'),
            'delete .csv file after analysis':
                results.getboolean('delete .csv file after analysis'),
            'store processed .csv file': results.getboolean('store processed .csv file'),
            'store generated statistical .csv file':
                results.getboolean('store generated statistical .csv file'),
            'store final analysed .csv file':
                results.getboolean('store final analysed .csv file'),
            'split results by (Turn Points / Distance / Speed / Time / '
            'Displacement / perc. motile)': split_results_by,
            'split violin plots on': split_on_percentage,
            'save large plots': results.getboolean('save large plots'),
            'save rose plot': results.getboolean('save rose plot'),
            'save time violin plot': results.getboolean('save time violin plot'),
            'save acr violin plot': results.getboolean('save acr violin plot'),
            'save length violin plot': results.getboolean('save length violin plot'),
            'save turning point violin plot':
                results.getboolean('save turning point violin plot'),
            'save speed violin plot': results.getboolean('save speed violin plot'),
            'save angle distribution plot / bins':
                results.getint('save angle distribution plot / bins'),
            'save displacement violin plot':
                results.getboolean('save displacement violin plot'),
            'save percent motile plot': results.getboolean('save percent motile plot'),
            'collate results csv to xlsx': results.getboolean('collate results csv to xlsx'),

            # PLOT Y-AXIS LIMITS
            'turning point violin plot min':
                val_to_float_or_false(y_axis_lim.get('turning point violin plot min')),
            'turning point violin plot max':
                val_to_float_or_false(y_axis_lim.get('turning point violin plot max')),
            'length violin plot min':
                val_to_float_or_false(y_axis_lim.get('length violin plot min')),
            'length violin plot max':
                val_to_float_or_false(y_axis_lim.get('length violin plot max')),
            'speed violin plot min':
                val_to_float_or_false(y_axis_lim.get('speed violin plot min')),
            'speed violin plot max':
                val_to_float_or_false(y_axis_lim.get('speed violin plot max')),
            'time violin plot min':
                val_to_float_or_false(y_axis_lim.get('time violin plot min')),
            'time violin plot max':
                val_to_float_or_false(y_axis_lim.get('time violin plot max')),
            'displacement violin plot min':
                val_to_float_or_false(y_axis_lim.get('displacement violin plot min')),
            'displacement violin plot max':
                val_to_float_or_false(y_axis_lim.get('displacement violin plot max')),
            'percent motile plot min':
                val_to_float_or_false(y_axis_lim.get('percent motile plot min')),
            'percent motile plot max':
                val_to_float_or_false(y_axis_lim.get('percent motile plot max')),
            'acr violin plot min':
                val_to_float_or_false(y_axis_lim.get('acr violin plot min')),
            'acr violin plot max':
                val_to_float_or_false(y_axis_lim.get('acr violin plot max')),

            # LOGGING SETTINGS
            'log to file': log_settings.getboolean('log to file'),
            'log file path': log_settings.get('log file path'),
            'shorten displayed logging output':
                log_settings.getboolean('shorten displayed logging output'),
            'shorten logfile logging output':
                log_settings.getboolean('shorten logfile logging output'),
            'set logging level (debug/info/warning/critical)': set_log_level,
            'log_level': set_log_level_setting,
            'verbose': verbose,

            # ADVANCED VIDEO SETTINGS
            'include luminosity in tracking calculation':
                adv_video.getboolean('include luminosity in tracking calculation'),
            'color filter': colour_filter,
            'minimal frame count': adv_video.getint('minimal frame count'),
            'stop evaluation on error': adv_video.getboolean('stop evaluation on error'),
            'list save length interval': adv_video.getint('list save length interval'),
            'save video file extension': adv_video.get('save video file extension'),
            'save video fourcc codec': adv_video.get('save video fourcc codec'),
            'adaptive double threshold': adv_video.getfloat('adaptive double threshold'),

            # ADVANCED TRACK DATA ANALYSIS SETTINGS
            'maximal consecutive holes': adv_track.getint('maximal consecutive holes'),
            'maximal empty frames in %':
                adv_track.getfloat('maximal empty frames in %') / 100 + 1,
            'percent quantiles excluded area':
                adv_track.getfloat('percent quantiles excluded area') / 100,
            'try to omit motility outliers':
                adv_track.getboolean('try to omit motility outliers'),
            'stop excluding motility outliers if total count above percent':
                adv_track.getfloat(
                    'stop excluding motility outliers if total count above percent') / 100,
            'exclude measurement when above x times average area':
                adv_track.getfloat('exclude measurement when above x times average area'),
            'average width/height ratio min.': min_size_ratio,
            'average width/height ratio max.': max_size_ratio,
            'percent of screen edges to exclude':
                adv_track.getfloat('percent of screen edges to exclude') / 100,
            'maximal recursion depth': adv_track.getint('maximal recursion depth'),
            'limit track length exactly': adv_track.getboolean('limit track length exactly'),
            'compare angle between n frames': adv_track.getint('compare angle between n frames'),
            'force tracking.ini fps settings':
                adv_track.getboolean('force tracking.ini fps settings'),

            # GAUSSIAN-SUM FIR FILTER SETTINGS
            'disable gsff': gsff.getboolean('disable gsff'),
            'number of LSFFs': gsff.getint('number of LSFFs'),
            'minimum horizon size': gsff.getint('minimum horizon size'),
            'maximum horizon size': gsff_max_size,

            # HOUSEKEEPING
            'previous directory': housekeeping.get('previous directory', fallback='./'),
            'shut down after analysis': housekeeping.getboolean('shut down after analysis'),

            # TEST SETTINGS
            'debugging': test.getboolean('debugging'),
            'path to test video': test.get('path to test video'),

            # TPU SETTINGS (new; defaults applied when section is absent)
            'frame batch size': tpu_int('frame batch size'),
            'max detections per frame': tpu_int('max detections per frame'),
            'max track slots': tpu_int('max track slots'),
            'connected components max iterations':
                tpu_int('connected components max iterations'),
            'use pallas kernels': tpu_bool('use pallas kernels'),
            'host decode threads': tpu_int('host decode threads'),
            'prefetch batches': tpu_int('prefetch batches'),
            'transfer mode': str(tpu.get('transfer mode',
                                         _TPU_DEFAULTS['transfer mode'])).strip().lower(),
            'decode mode': str(tpu.get('decode mode',
                                       _TPU_DEFAULTS['decode mode'])).strip().lower(),
            'max foreground pixels per frame':
                tpu_int('max foreground pixels per frame'),
            'max bounding box height': tpu_int('max bounding box height'),
            'luminosity window size': tpu_int('luminosity window size'),
            'cv2 exact rects': tpu_bool('cv2 exact rects'),
            'cv2 exact rects max detections':
                tpu_int('cv2 exact rects max detections'),
            'cv2 exact centers': str(tpu.get(
                'cv2 exact centers',
                _TPU_DEFAULTS['cv2 exact centers'])).strip().lower(),
            'wire format': tpu.get('wire format', 'auto').strip().lower(),
            'run cc': tpu.get('run cc', 'auto').strip().lower(),
            'compact emissions readback':
                tpu_bool('compact emissions readback'),
            'profile stages': tpu_bool('profile stages'),
            'jax profiler dir': str(tpu.get(
                'jax profiler dir',
                _TPU_DEFAULTS['jax profiler dir'])).strip(),
            'use table cc': tpu_bool('use table cc'),
            'shard videos across devices':
                tpu_bool('shard videos across devices'),
            'shard dense assignment across devices':
                tpu_bool('shard dense assignment across devices'),
            'dense assignment shard threshold':
                tpu_int('dense assignment shard threshold'),

            # Internal
            'tracking_ini_filepath': tracking_ini_filepath,
            'perc_motile_warning': perc_motile_warning,
        }

        check_text = ' Check tracking.ini file at: {}'.format(tracking_ini_filepath)
        assert settings_dict['minimum horizon size'] >= 0, \
            "'minimum horizon size' in 'GAUSSIAN-SUM FIR FILTER SETTINGS' less than 0." \
            + check_text
        assert settings_dict['number of LSFFs'] > 1, \
            "'number of LSFFs' in 'GAUSSIAN-SUM FIR FILTER SETTINGS' less than 2." + check_text
        assert settings_dict['frames per second'] > 0, \
            "'frames per second' in 'BASIC RECORDING SETTINGS' zero or negative." + check_text
        assert settings_dict['pixel per micrometre'] > 0, \
            "'pixel per micrometre' in 'BASIC RECORDING SETTINGS' zero or negative." + check_text
        assert settings_dict['frame height'] > 0, \
            "'frame height' in 'BASIC RECORDING SETTINGS' zero or negative." + check_text
        assert settings_dict['frame width'] > 0, \
            "'frame width' in 'BASIC RECORDING SETTINGS' zero or negative." + check_text

        for key, value in settings_dict.items():
            if value is None and key != 'maximum horizon size':
                LOG.critical('tracking.ini is missing a value in %s', key)
                settings_dict = None
                break
    except (TypeError, ValueError, KeyError, AssertionError) as ex:
        LOG.exception('An exception of type %s occurred while attempting to read '
                      'tracking.ini. Arguments: %r', type(ex).__name__, ex.args)
        settings_dict = None

    if not settings_dict:
        create_configs(config_filepath=tracking_ini_filepath, open_editor=False)
        return None
    return settings_dict
