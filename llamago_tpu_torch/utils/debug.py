"""Host-side runtime guards (CLI `--debug`, or LLAMAGO_DEBUG=1).

`check()` costs one `if DEBUG` when disabled; it guards the engine's
scheduler invariants.
"""

from __future__ import annotations

import os

DEBUG = os.environ.get("LLAMAGO_DEBUG", "0") == "1"


def enable_debug_checks() -> None:
    """Turn on the engine invariant checks (CLI --debug)."""
    global DEBUG
    DEBUG = True


class InvariantError(AssertionError):
    pass


def check(cond: bool, msg: str, **ctx) -> None:
    """Host-side invariant, active only under LLAMAGO_DEBUG/--debug."""
    if DEBUG and not cond:
        detail = " ".join(f"{k}={v!r}" for k, v in ctx.items())
        raise InvariantError(f"{msg} {detail}".strip())
