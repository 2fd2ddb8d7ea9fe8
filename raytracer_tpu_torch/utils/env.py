"""The measurement hooks' environment variables, read at each call.

Each hook of the regen engine and of the BVH traversal wrapper keeps the
JAX package's name and meaning, and is read where it is used, so a test or
a script may set it between two renders. A value outside a hook's set
raises: a misspelt hook must not render the default path silently.
"""

from __future__ import annotations

import os


def choice(name: str, default: str, allowed: tuple[str, ...]) -> str:
    """The value of ``name`` (``default`` when unset), one of ``allowed``."""
    value = os.environ.get(name, default)
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: the port takes one of {allowed}")
    return value


def flag(name: str, default: bool) -> bool:
    """``name`` as ``0`` or ``1``."""
    return choice(name, "1" if default else "0", ("0", "1")) == "1"


def count(name: str, minimum: int) -> int | None:
    """``name`` as an integer of at least ``minimum``; None when unset."""
    value = os.environ.get(name)
    if value is None:
        return None
    try:
        n = int(value)
    except ValueError:
        n = minimum - 1
    if n < minimum:
        raise ValueError(f"{name}={value!r}: the port takes an integer >= {minimum}")
    return n
