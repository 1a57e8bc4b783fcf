"""GV front end: reader of pre-tabulated Hugenholtz diagram files.

Reference: FeynmanDiagram.jl/src/frontend/GV.jl + GV_diagrams/readfile.jl.
The table directory is configurable; see ``set_table_path``.
"""
from __future__ import annotations

import os
from typing import List, Optional

_TABLE_PATH: Optional[str] = os.environ.get("FDTPU_GV_TABLES")


def set_table_path(path: str) -> None:
    global _TABLE_PATH
    _TABLE_PATH = path


def get_table_path() -> str:
    if _TABLE_PATH is None:
        raise RuntimeError(
            "GV diagram tables not configured: call gv.set_table_path() or set "
            "FDTPU_GV_TABLES to a directory containing groups_* table files")
    return _TABLE_PATH


from .readfile import read_diagrams, read_vertex4_diagrams  # noqa: E402
from .gv import diagsGV, diagsGV_series, diagsGV_ver4  # noqa: E402
