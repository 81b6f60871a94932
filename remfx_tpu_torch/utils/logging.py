"""Logging of the port (``remfx_tpu/utils/logging.py``).

One stream handler per named logger. The JAX package mutes every process
but JAX's process 0; the port trains in one process (DDP waits for
ROADMAP.md §A10), so every record is emitted.
"""

import logging


def get_logger(name: str = __name__) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
