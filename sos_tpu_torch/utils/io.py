"""Small host-side helpers (reference utils.py:120-172 equivalents).

The port's copy of `sos_tpu/utils/io.py`.
"""

from __future__ import annotations

import os
from typing import Iterator


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def cycle(iterable_factory) -> Iterator:
    """Endless iterator over a re-creatable iterable (fresh epoch each pass).

    Unlike itertools.cycle, re-invokes the factory so shuffling batchers
    re-shuffle (the reference's `cycle` re-iterates the DataLoader,
    utils.py:169-172).
    """
    while True:
        produced = False
        for item in iterable_factory():
            produced = True
            yield item
        if not produced:
            raise ValueError("cycle() over an empty iterable would spin forever")
