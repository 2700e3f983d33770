"""Where the program keeps what it builds: `cache/` at the root of its
checkout, which .gitignore lists. Nothing is written outside the checkout."""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_path(*parts: str) -> str:
    """`cache/<parts...>` under the checkout; the directory is created."""
    path = os.path.join(CHECKOUT_DIR, "cache", *parts)
    os.makedirs(path, exist_ok=True)
    return path
