"""Metric readers, found by name.

Each metric of BENCHMARK.json has a reader in ``benchmark/metrics/readers/``:
the file named as the metric, or as the part of its name before the first
dot (``decode_step_ms.batch`` and ``decode_step_ms.chat`` share
``decode_step_ms.py``). A reader is a module with ``read(run)``, which
returns the number, or None where the run holds nothing to read; the harness
then leaves the metric out of the result.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Optional

READERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "readers")


def reader(name: str) -> Callable[[object], Optional[float]]:
    for stem in (name, name.split(".")[0]):
        path = os.path.join(READERS, stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"gbench_reader_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {name!r} in {READERS}")
