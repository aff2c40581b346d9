"""Finds the benchmark's parts by name: ``<base>/<folder>/<name>.py``,
loaded as a module of its own.  A later configuration, traffic mix,
metric, kernel or judge is a new file, found by the name that
``BENCHMARK.json`` or a configuration gives it."""
from __future__ import annotations

import importlib.util
import os
import re


def path(base: str, folder: str, name: str) -> str:
    return os.path.join(base, folder, name + ".py")


def load(base: str, folder: str, name: str):
    """The module ``<base>/<folder>/<name>.py``; None if there is none."""
    p = path(base, folder, name)
    if not os.path.exists(p):
        return None
    key = "perfbench_%s_%s" % (folder, re.sub(r"\W", "_", name))
    spec = importlib.util.spec_from_file_location(key, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(base: str, folder: str) -> list[str]:
    """Every part's name in ``<base>/<folder>/``, sorted."""
    d = os.path.join(base, folder)
    if not os.path.isdir(d):
        return []
    return sorted(f[:-3] for f in os.listdir(d)
                  if f.endswith(".py") and not f.startswith("_"))
