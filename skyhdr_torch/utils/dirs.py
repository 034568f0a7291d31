"""Directory plumbing (`skyhdr.utils.dirs`, reference utils.py:31-59)."""

from __future__ import annotations

import os
from datetime import datetime


def timestamp() -> str:
    return datetime.now().strftime("%Y-%m-%d-%H-%M-%S")


def create_new_dir(root: str, name: str | None = None) -> str:
    """mkdir -p root/name (timestamp when name is None), return the path."""
    path = os.path.join(root, name if name is not None else timestamp())
    os.makedirs(path, exist_ok=True)
    return path
