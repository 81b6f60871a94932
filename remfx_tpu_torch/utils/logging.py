"""Logging of the port (``remfx_tpu/utils/logging.py``).

One stream handler per named logger. As the JAX package mutes every
process but JAX's process 0, a rank other than 0 of a process group
(``parallel/launch.py``, ``RANK`` in the environment) emits warnings
and errors only.
"""

import logging
import os


def _level() -> int:
    return logging.INFO if int(os.environ.get("RANK", 0)) == 0 else logging.WARNING


def get_logger(name: str = __name__) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(_level())
    return logger


def mute_other_ranks():
    """The level of every logger of the port made by ``get_logger`` before
    this process learnt its rank, set by it."""
    for name, logger in logging.Logger.manager.loggerDict.items():
        if name.startswith("remfx_tpu_torch") and isinstance(logger, logging.Logger) \
                and logger.handlers:
            logger.setLevel(_level())
