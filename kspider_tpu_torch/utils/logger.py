"""Colored stderr logger for the CLI.

Mirrors the behavior of the reference logger
(kSpider/pykSpider/kSpider2/customLogger.py): INFO/SUCCESS/WARNING
are suppressed with ``--quiet``; ERROR always prints and exits(1).  The
reference stores the quiet flag in an inverted ``ACTIVE`` attribute; we keep
a plain ``quiet`` flag with identical observable behavior.
"""

import sys


class _Color:
    RED = "\033[1;31m"
    GREEN = "\033[1;32m"
    YELLOW = "\033[1;33m"
    RESET = "\033[0m"


class Logger:
    def __init__(self, quiet: bool = False, file=None):
        self.quiet = quiet
        self.file = file if file is not None else sys.stderr

    def _emit(self, tag: str, msg: str, color: str) -> None:
        use_color = hasattr(self.file, "isatty") and self.file.isatty()
        if use_color:
            print(f"{color}[{tag}] {msg}{_Color.RESET}", file=self.file)
        else:
            print(f"[{tag}] {msg}", file=self.file)

    def SUCCESS(self, msg: str) -> None:
        if not self.quiet:
            self._emit("SUCCESS", msg, _Color.GREEN)

    def INFO(self, msg: str) -> None:
        if not self.quiet:
            self._emit("INFO", msg, _Color.YELLOW)

    def WARNING(self, msg: str) -> None:
        if not self.quiet:
            self._emit("WARNING", msg, _Color.YELLOW)

    def ERROR(self, msg: str) -> None:
        self._emit("ERROR", msg, _Color.RED)
        sys.exit(1)
