"""Colorized console output + structured logging (reference Colorize
helper: main.go:389-392)."""

from __future__ import annotations

import os
import re
import sys
import time

_CODES = {
    "black": "30", "red": "31", "green": "32", "yellow": "33",
    "blue": "34", "magenta": "35", "cyan": "36", "white": "37",
    "light_gray": "37", "dark_gray": "90", "light_red": "91",
    "light_green": "92", "light_yellow": "93", "light_blue": "94",
    "light_magenta": "95", "light_cyan": "96", "reset": "0",
}
_TAG = re.compile(r"\[([a-z_]+)\]")


def colorize(template: str, end: str = "\n", file=None) -> None:
    """Print a colorstring template: "[magenta]hello [light_blue]world".
    Colors are stripped when the target is not a TTY or NO_COLOR is set."""
    out = file or sys.stdout
    use_color = out.isatty() and os.environ.get("NO_COLOR") is None

    def sub(m):
        code = _CODES.get(m.group(1))
        if code is None:
            return m.group(0)
        return f"\x1b[{code}m" if use_color else ""

    text = _TAG.sub(sub, template)
    if use_color:
        text += "\x1b[0m"
    print(text, end=end, file=out, flush=True)


_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_LEVEL_COLOR = {"debug": "dark_gray", "info": "cyan",
                "warn": "yellow", "error": "light_red"}


def log(level: str, msg: str, **fields) -> None:
    """Leveled, timestamped, key=value log line to stderr.
    Threshold via LLAMAGO_LOG (debug|info|warn|error), default info."""
    threshold = _LEVELS.get(os.environ.get("LLAMAGO_LOG", "info"), 20)
    if _LEVELS.get(level, 20) < threshold:
        return
    ts = time.strftime("%H:%M:%S")
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    color = _LEVEL_COLOR.get(level, "white")
    colorize(f"[dark_gray]{ts} [{color}]{level.upper():5s}[reset] {msg}"
             + (f" [dark_gray]{kv}" if kv else ""), file=sys.stderr)
