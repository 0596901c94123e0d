"""Faults planted under the timed path, for the checks that a broken run
comes out not correct (pmctf_bench/tests/ and ``calibrate.py --fault``).

Each family brings the faults that apply to it (families/<family>.py):
``MODEL_FAULTS``, each a function that breaks the port's model, and
``GLOBAL_FAULTS``, each a context manager inside which the port's code is
broken. ``planted(name, family)`` is a context manager: inside it the
fault is in place, and it yields the ``break_port`` function that
``harness.run`` applies to the port's model (None where the fault is
planted elsewhere). Nothing of the port's files changes; everything is
undone on leaving.
"""

from __future__ import annotations

import contextlib
from types import ModuleType
from typing import Callable, Iterator, Optional

from .cells import DEFAULT_FAMILY, load_family


@contextlib.contextmanager
def planted(name: Optional[str], family: Optional[ModuleType] = None
            ) -> Iterator[Optional[Callable]]:
    """Plant fault `name` (None: none) of `family` (the default family's
    if None) for the duration of the block."""
    family = family or load_family(DEFAULT_FAMILY)
    if name is None:
        yield None
    elif name in family.MODEL_FAULTS:
        yield family.MODEL_FAULTS[name]
    elif name in family.GLOBAL_FAULTS:
        with family.GLOBAL_FAULTS[name]():
            yield None
    else:
        raise KeyError(f"no fault {name!r}; faults: "
                       f"{[*family.MODEL_FAULTS, *family.GLOBAL_FAULTS]}")
