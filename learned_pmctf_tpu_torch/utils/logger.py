"""File and console logging, and the environment line of a training log.

Counterpart of learned_pmctf_tpu/utils/logger.py.
"""

from __future__ import annotations

import logging
import sys

_initialized = {}


def get_root_logger(logger_name: str = "pmctf_torch",
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The named logger, writing to stdout and, if given, `log_file`; set
    up once a process (later calls return it as it is)."""
    logger = logging.getLogger(logger_name)
    if logger_name in _initialized:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(log_level)
    logger.propagate = False
    _initialized[logger_name] = True
    return logger


def get_env_info() -> str:
    import torch
    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines += [f"device {i}: {torch.cuda.get_device_name(i)}"
                  for i in range(torch.cuda.device_count())]
    else:
        lines.append("no CUDA device")
    return "\n\t".join(["Environment:"] + lines)

