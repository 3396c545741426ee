"""Logging setup (port of quant_tpu/utils/logging_utils.py)."""

import logging

_LEVELS = {
    'CRITICAL': logging.CRITICAL,
    'ERROR': logging.ERROR,
    'WARNING': logging.WARNING,
    'INFO': logging.INFO,
    'DEBUG': logging.DEBUG,
}


def init_logging(level: str = 'INFO') -> None:
    logging.basicConfig(
        level=_LEVELS.get(str(level).upper(), logging.INFO),
        format='%(asctime)s %(name)s %(levelname)s: %(message)s',
    )
