"""Faults planted in the program underneath a run, to show that the check
fails them (``tests/test_bench_faults.py`` on the CPU, ``calibrate.py`` on
the card). A fault is a file, ``planted/<name>.py``, holding a function of
the same name that returns a context manager; it patches one function of
the port and restores it. :func:`find` loads a fault by its name, so a new
fault is a new file."""

from __future__ import annotations

import contextlib
import pathlib

from .reference import load_by_path

__all__ = ["find", "patched"]


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def find(name: str, root: pathlib.Path):
    """The fault ``name`` of the benchmark directory ``root``
    (``root/planted/<name>.py``)."""
    path = pathlib.Path(root) / "planted" / f"{name}.py"
    if not path.is_file():
        known = sorted(p.stem for p in path.parent.glob("[!_]*.py"))
        raise KeyError(f"no fault {name!r} in {path.parent}: {known}")
    return getattr(load_by_path(path, "port_bench.planted"), name)
