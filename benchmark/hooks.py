"""Wrapping the program's functions from the benchmark's side.

A target is ``"package.module:attribute"`` or ``"package.module:Class.
method"``: the name the caller looks up when it calls.  Wrapping a module
global reaches every caller that looks the name up in that module at call
time; wrapping a method reaches every instance.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, List, Optional, Tuple


def resolve(target: str) -> Optional[Tuple[object, str]]:
    """(owner, attribute) of a target, None where the module or any part
    of the path is missing."""
    module, _, path = target.partition(":")
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    if not hasattr(owner, parts[-1]):
        return None
    return owner, parts[-1]


class Patches:
    """Wrappers installed for the length of a ``with`` block, removed in
    reverse order on its exit."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, target: str, make: Callable[[Callable], Callable]) -> bool:
        """Replace ``target`` by ``make(original)``; False (and a line on
        stderr) where the target is missing."""
        found = resolve(target)
        if found is None:
            print(f"# benchmark: {target} not found in the program",
                  file=sys.stderr)
            return False
        owner, attr = found
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
        return False
