"""Plain references, one file a configuration (``reference/<config>.py``),
found by the configuration's name."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

__all__ = ["load_reference", "load_by_path"]


def load_by_path(path: pathlib.Path, package: str):
    """Import the module at ``path`` as ``package.<stem>`` (stems may hold
    '-' and '.')."""
    name = f"{package}.{path.stem.replace('-', '_').replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_reference(root: pathlib.Path, config: str):
    return load_by_path(root / "reference" / f"{config}.py", __name__)
