"""Loading the files a cell is made of, by path, so that a cell, a metric,
a driver or a reference added as a new file is found by its name alone."""

from __future__ import annotations

import importlib.util
import json
import os
import re


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str):
    """The Python module in the file at ``path``."""
    spec = importlib.util.spec_from_file_location("benchmark_file_" + re.sub(r"\W", "_", path),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(spec: dict):
    """The plain reference module a cell's configuration names."""
    return load_module(os.path.join(spec["dir"], "reference", f"{spec['config']['reference']}.py"))
