"""Logging setup (ref: include/mitsuba/core/logger.h ETrace..EError levels,
per-node `mitsuba.<node>.log` file appender + stdout, mitsuba.cpp:262-276).

EError in the reference throws; `log.error(...)` followed by raising is the
equivalent here.  The config-dump discipline (DRMLTConfiguration::dump,
drmlt.h:85-120) is `dump_config`.
"""
from __future__ import annotations

import dataclasses
import logging
import sys


def setup_logging(level: str = "info", log_file: str | None = None,
                  quiet: bool = False) -> logging.Logger:
    logger = logging.getLogger("drmlt_mitsuba")
    logger.setLevel(getattr(logging, level.upper()))
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname).4s %(name)s: %(message)s", "%H:%M:%S"
    )
    if not quiet:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def dump_config(logger: logging.Logger, name: str, cfg):
    """Log every field of a (dataclass) config at render start."""
    logger.info("%s configuration:", name)
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(cfg):
            logger.info("   %s = %s", f.name, getattr(cfg, f.name))
    elif isinstance(cfg, dict):
        for k, v in cfg.items():
            logger.info("   %s = %s", k, v)
