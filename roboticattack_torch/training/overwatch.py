"""Process-aware logging (the reference's `overwatch`, the JAX package's
`training/overwatch.py`).

The rank comes from the process group this package joins
(`parallel/distributed.current()`); a process outside any group behaves as
rank 0 of 1, as a single-process JAX run does.
"""

from __future__ import annotations

import logging
import sys
from functools import wraps

from ..parallel import distributed

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s :: %(message)s"


def _rank_world() -> tuple:
    info = distributed.current()
    return (0, 1) if info is None else (info.rank, info.world_size)


def _is_rank_zero() -> bool:
    return _rank_world()[0] == 0


class Overwatch:
    def __init__(self, name: str) -> None:
        self.logger = logging.getLogger(name)
        if not self.logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
            self.logger.addHandler(handler)
            self.logger.setLevel(logging.INFO if _is_rank_zero() else logging.ERROR)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)

    def rank_zero_only(self, fn):
        """Decorator: run `fn` only on rank 0 (the reference's overwatch.py:75-92)."""

        @wraps(fn)
        def wrapper(*args, **kwargs):
            if _is_rank_zero():
                return fn(*args, **kwargs)
            return None

        return wrapper

    @property
    def rank(self) -> int:
        return _rank_world()[0]

    @property
    def world_size(self) -> int:
        return _rank_world()[1]

    def is_rank_zero(self) -> bool:
        return _is_rank_zero()


def initialize_overwatch(name: str) -> Overwatch:
    return Overwatch(name)
