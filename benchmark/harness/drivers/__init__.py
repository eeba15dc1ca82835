"""
The drivers of the program's entries, one file an entry: a traffic file's
``"entry"`` names ``drivers/<entry>.py``, whose ``Driver`` class drives it
(``harness/base.py`` says what a driver offers). A new entry is a new file
here; nothing names one.
"""

from __future__ import annotations

import importlib


def load(entry: str):
    """The ``Driver`` class of ``drivers/<entry>.py``."""
    if not entry.isidentifier():
        raise ValueError(f"entry {entry!r} is not a module name")
    return importlib.import_module(f"{__name__}.{entry}").Driver
