"""Process-rank-aware logging (the port's copy of
celeste_jl_tpu/utils/log.py, Log.jl:9-71).

Python's logging module already serializes writes, so this is a thin veneer
adding the `[rank]` prefix and the reference's level names. The rank is the
torch.distributed rank, or 0 when no process group is initialised.
"""

import logging
import os
import sys

_LEVELS = {"ERROR": logging.ERROR, "WARN": logging.WARNING,
           "INFO": logging.INFO, "DEBUG": logging.DEBUG}


def _rank():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


_logger = logging.getLogger("celeste_jl_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(_LEVELS.get(os.environ.get("CELESTE_LOG_LEVEL", "INFO"),
                                 logging.INFO))
    _logger.propagate = False


def _fmt(msg):
    return f"[{_rank()}] {msg}"


def error(msg):
    _logger.error(_fmt(msg))


def warn(msg):
    _logger.warning(_fmt(msg))


def info(msg):
    _logger.info(_fmt(msg))


def debug(msg):
    _logger.debug(_fmt(msg))


def exception(exc):
    _logger.error(_fmt(f"exception: {exc!r}"), exc_info=exc)
