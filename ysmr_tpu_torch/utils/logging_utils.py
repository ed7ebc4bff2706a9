# Copied from ysmr_tpu/utils/logging_utils.py; only the import lines differ.
#!/usr/bin/env python3
"""Multiprocess-safe queue logging, logfile rotation, and startup banner.

Capability parity with the reference logging subsystem (helper_file.py:318-361
``check_logfile``, :922-1011 ``get_loggers``/``log_formats``, :1014-1128
``log_infos``, :1131-1215 queue configurers/listener, :1577-1601
``stop_logging_queue``): a namespaced ``'ysmr'`` logger fed through a queue so
it stays safe under multiprocessing, long/short line formats, size-based
``.log.1``..``.log.9`` rotation, and a banner explaining the format.
"""

import logging
import logging.handlers
import os
import subprocess
import sys
from logging.handlers import QueueHandler, QueueListener
from queue import Queue
from time import sleep


def log_formats():
    """Long and short logging formats (reference helper_file.py:993-1011)."""
    long_format = ('{asctime:}\t{funcName:15.15}\t{lineno:>4}\t'
                   '{levelname:8.8}\t{process:>5}:\t{message}')
    short_format = '{asctime:}\t{levelname:8.8}\t{process:>5}:\t{message}'
    return long_format, short_format


def logfile_padding(logfile):
    """Append a blank separator line unless the file already ends on one."""
    with open(logfile, 'rb+') as fh:
        fh.seek(0, os.SEEK_END)
        if fh.tell() == 0:
            return
        fh.seek(-1, os.SEEK_END)
        if fh.read(1) not in (b'\n', b'\r'):
            fh.write(b'\n')


def check_logfile(path, max_size=2 ** 20, keep=9):
    """Size-based logfile rollover keeping ``.1`` (newest) .. ``.9`` (oldest).

    Same capability as the reference's homemade rotation
    (helper_file.py:318-361): a file below ``max_size`` is only
    newline-padded; a larger one is rotated — every numbered sibling shifts
    up one slot (the ``.keep`` oldest is dropped) and the live file becomes
    ``.1``.  Unlike the reference this is a plain descending shift with no
    gap-detection heuristics.
    """
    size = os.path.getsize(path) if os.path.isfile(path) else 0
    if size < max_size:
        if size:
            logfile_padding(path)
        return path
    for slot in range(keep, 0, -1):
        numbered = '{}.{}'.format(path, slot)
        if not os.path.isfile(numbered):
            continue
        try:
            if slot == keep:
                os.remove(numbered)
            else:
                os.replace(numbered, '{}.{}'.format(path, slot + 1))
        except OSError:
            pass
    try:
        os.replace(path, '{}.1'.format(path))
    except OSError:
        pass
    return path


def get_loggers(log_level=logging.DEBUG, logfile_name='./logfile.log',
                short_stream_output=False, short_file_output=False,
                log_to_file=False, settings=None):
    """Set up the 'ysmr' logger with queue-based handlers (idempotent).

    If ``settings`` carries a ``logging_queue`` (multiprocess mode), attach a
    QueueHandler targeting it instead — the dedicated listener process then
    owns the real handlers (reference helper_file.py:922-990).
    """
    if isinstance(settings, dict) and 'logging_queue' in settings:
        logging_configurer(settings)
        return

    logger = logging.getLogger('ysmr')
    logger.propagate = False
    if any(isinstance(h, QueueHandler) for h in logger.handlers):
        return  # already wired up
    long_format, short_format = log_formats()
    logging.basicConfig(format=long_format, style='{')
    logger.setLevel(log_level)

    def _sink(stream_or_file, short):
        handler = logging.StreamHandler(sys.stdout) if stream_or_file is None \
            else logging.FileHandler(filename=stream_or_file, mode='a')
        handler.setLevel(log_level)
        handler.setFormatter(logging.Formatter(
            short_format if short else long_format, style='{'))
        return handler

    sinks = [_sink(None, short_stream_output)]
    if log_to_file:
        sinks.append(_sink(logfile_name, short_file_output))
    log_queue = Queue(-1)
    logger.addHandler(QueueHandler(log_queue))
    listener = QueueListener(log_queue, *sinks)
    listener.start()
    # stop_logging_queue() finds the listener through this attribute
    logger._ysmr_queue_listener = listener


def logging_configurer(settings):
    """Attach a QueueHandler for the multiprocess logging queue."""
    log = logging.getLogger('ysmr')
    if log.handlers:
        return
    log.addHandler(logging.handlers.QueueHandler(settings['logging_queue']))
    log.setLevel(settings['log_level'])


def logging_listener_configurer(settings):
    """Configure real handlers inside the listener process."""
    log = logging.getLogger('ysmr')
    log.propagate = False
    long_fmt, short_fmt = log_formats()
    sinks = [(logging.StreamHandler(sys.stdout),
              settings['shorten logfile logging output'])]
    if settings['log to file']:
        sinks.append((logging.FileHandler(settings['log file path'], mode='a'),
                      settings['shorten displayed logging output']))
    for handler, short in sinks:
        handler.setFormatter(logging.Formatter(
            short_fmt if short else long_fmt, style='{'))
        handler.setLevel(settings['log_level'])
        log.addHandler(handler)


def logging_listener(settings):
    """Consume log records from the multiprocess queue; stop on None sentinel."""
    record_queue = settings['logging_queue']
    logging_listener_configurer(settings)
    while True:
        try:
            record = record_queue.get()
        except Exception:
            _report_listener_failure(settings)
            break
        if record is None:
            break
        try:
            logging.getLogger(record.name).handle(record)
        except Exception:
            _report_listener_failure(settings)
            break


def _report_listener_failure(settings):
    import traceback
    print('Logging listener failed:', file=sys.stderr)
    traceback.print_exc(file=sys.stderr)
    try:
        with open(settings['log file path'], 'w+') as sink:
            traceback.print_exc(file=sink)
    except (FileNotFoundError, PermissionError):
        pass


def stop_logging_queue(logger=None, settings=None):
    """Send the None sentinel and stop any in-process QueueListener."""
    if isinstance(settings, dict) and 'logging_queue' in settings:
        try:
            settings['logging_queue'].put(None, True, 5)
        except Exception:
            try:
                settings['logging_queue'].put_nowait(None)
            except Exception:
                pass
    ysmr_logger = logging.getLogger('ysmr')
    listener = getattr(ysmr_logger, '_ysmr_queue_listener', None)
    if listener is not None:
        try:
            listener.stop()
        except (AttributeError, TypeError, RuntimeError):
            pass
        ysmr_logger._ysmr_queue_listener = None
    sleep(.1)


def log_infos(settings):
    """Startup banner + settings-derived warnings.

    Capability parity with the reference's ``log_infos``
    (helper_file.py:1014-1128): a header line that explains the log columns,
    then warnings/infos derived from every consequential setting.
    Returns the ``#`` filler line used to frame the run in the log.
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    long_format, short_format = log_formats()
    uses_short = settings['shorten logfile logging output'] or (
        settings['shorten displayed logging output'] and settings['log to file'])
    header = (short_format if uses_short else long_format).format(**{
        'asctime': 'YYYY-MM-DD HH:MM:SS,mmm',
        'name': 'logger name',
        'funcName': 'function name',
        'filename': 'file name',
        'lineno': 'lNr',
        'levelname': 'level',
        'process': 'PID',
        'message': 'Message (lNr: line number, PID: Process ID)',
    })
    filler = '\t'.join('#' * len(col) for col in header.split('\t'))
    logger.info('Column legend\n{0}\n{1}\n{0}'.format(filler, header))

    # warnings for settings with destructive or surprising consequences
    if settings['shut down after analysis']:
        logger.warning('The machine will power off once the batch completes.')
    if settings['debugging']:
        logger.warning('Debug/test mode is active.')
    if not settings['rename previous result .csv']:
        logger.warning('Existing result CSVs will be replaced in place.')
    if settings['delete .csv file after analysis']:
        logger.warning('Intermediate CSVs are deleted once each file finishes.')
    if settings['select files'] and settings['debugging']:
        logger.warning('File selection dialog suppressed while debugging.')
    for warning in settings['perc_motile_warning'] or ():
        logger.warning(warning)

    logger.info('Settings: %s',
                os.path.abspath(settings['tracking_ini_filepath']))
    if settings['log to file']:
        logger.info('Logfile: %s', os.path.abspath(settings['log file path']))
    if settings['verbose']:
        logger.info('Verbose mode: log level forced to debug.')
    else:
        logger.info('Log level: %s',
                    settings['set logging level (debug/info/warning/critical)'])
    if settings['display video analysis']:
        logger.info('Live display of the analysis is on.')

    offset = settings['threshold offset for detection']
    double = settings['adaptive double threshold']
    if double > 0:
        logger.info('Threshold: adaptive double (mask offset %s, marker '
                    'offset %s).', offset, offset + double)
    elif double == 0:
        logger.info('Threshold: single adaptive, offset %s.', offset)
    else:
        logger.info('Threshold: frame-mean based, offset %s.', offset)
    if settings['disable gsff']:
        logger.info('GSFF disabled.')
    else:
        horizon = settings['maximum horizon size']
        logger.info('GSFF bank: %s filters, horizons %s..%s.',
                    settings['number of LSFFs'],
                    settings['minimum horizon size'],
                    'fps' if horizon is None else horizon)
    if settings['save video']:
        logger.info('Annotated output videos will be written.')
    if settings['include luminosity in tracking calculation']:
        logger.info('Luminosity joins the tracking distance metric (slower).')
    limit = settings['limit track length to x seconds']
    if limit:
        logger.info('Tracks are evaluated over at most %s s%s.', limit,
                    ' (exact: off-length tracks are dropped)'
                    if settings['limit track length exactly'] else '')
    else:
        logger.info('Tracks are evaluated at full length.')
    if not settings['maximal recursion depth']:
        logger.info("Track splitting is off ('maximal recursion depth' = 0); "
                    'expect fewer surviving tracks.')

    logger.debug('white bacteria on dark background: %s',
                 settings['white bacteria on dark background'])
    logger.debug('csv flush interval: %s rows',
                 settings['list save length interval'])
    logger.debug('pixel per micrometre: %s', settings['pixel per micrometre'])
    if settings['verbose']:
        logger.debug('full settings dump:')
        for item in settings.items():
            logger.debug('%s: %s', *item)
    return filler


def shutdown(seconds=60):
    """Attempt to power off the machine (reference helper_file.py:1604-1642)."""
    logger = logging.getLogger('ysmr').getChild(__name__)
    if os.name == 'nt':
        try:
            response = subprocess.run('shutdown -f -s -t {}'.format(seconds),
                                      stderr=subprocess.PIPE)
            response.check_returncode()
            logger.warning('Shutting down in %s s (shutdown -a to abort)', seconds)
        except (OSError, FileNotFoundError, subprocess.CalledProcessError) as err:
            logger.exception('Error during shutdown: %s', err)
        return
    for cmd in ('systemctl poweroff', 'sudo shutdown -h +1'):
        try:
            response = subprocess.run(cmd.split(), stderr=subprocess.PIPE)
            try:
                response.check_returncode()
            except AttributeError:
                pass
            logger.warning('Calling %r on system.', cmd)
            return
        except (OSError, FileNotFoundError, subprocess.CalledProcessError):
            continue
    logger.error('Could not shut down the system.')
