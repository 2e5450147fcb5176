"""Process-aware logging (reference utils/logging.py:8-88).

Process 0 logs INFO to console + file; other processes are ERROR-silenced
(the reference additionally patches builtins.print, pretrain.py:227-230 —
here non-zero processes simply get a silenced logger).
"""

from __future__ import annotations

import logging
import os
import sys


def get_logger(
    log_file: str | None = None,
    name: str = "dualvar_tpu_torch",
    process_index: int = 0,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if process_index == 0:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.setLevel(logging.ERROR)
        logger.addHandler(logging.NullHandler())
    return logger
