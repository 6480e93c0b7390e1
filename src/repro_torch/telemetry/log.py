"""Small leveled logger for the launch drivers (and warn-once degrades).

Port of ``src/repro/telemetry/log.py`` (plain Python, kept as is).

``get_logger("train").info("resumed from step 3")`` prints exactly what
the historical ad-hoc ``print(f"[train] resumed from step 3")`` printed —
byte-identical by construction, so every existing CLI grep keeps working
— until ``REPRO_LOG=json`` switches the stream to one structured JSON
object per line (``ts``/``level``/``component``/``msg``).  ``REPRO_LOG``
also accepts a level name (``debug|info|warn|error``) as a threshold,
optionally combined with the format: ``REPRO_LOG=json,debug``.

Warnings and errors are additionally mirrored into the tracer as instant
events when tracing is enabled, so a trace file carries the degrade
messages next to the spans they interrupted.  :func:`warn_once` is the
leveled face of the plan compiler's ChainLoweringError degrade fix: one
warning per site per process, every occurrence counted by the caller's
telemetry counter.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.telemetry import tracer as _tracer

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _config() -> tuple[int, bool]:
    """(threshold, json_mode) from ``REPRO_LOG``, re-read per call so
    tests and operators can flip it without re-imports."""
    raw = os.environ.get("REPRO_LOG", "")
    threshold, as_json = _LEVELS["info"], False
    for part in raw.split(","):
        part = part.strip().lower()
        if part == "json":
            as_json = True
        elif part in _LEVELS:
            threshold = _LEVELS[part]
    return threshold, as_json


class Logger:
    """One component's leveled logger; see module docstring."""

    def __init__(self, component: str):
        self.component = component

    def _emit(self, level: str, msg: str) -> None:
        threshold, as_json = _config()
        if _LEVELS[level] < threshold:
            return
        if as_json:
            print(json.dumps({"ts": time.time(), "level": level,
                              "component": self.component, "msg": msg}))
        elif level in ("warn", "error"):
            print(f"[{self.component}] {level.upper()}: {msg}")
        else:
            # The historical ad-hoc format, byte for byte.
            print(f"[{self.component}] {msg}")
        if level in ("warn", "error") and _tracer.enabled():
            _tracer.event(f"log.{level}", component=self.component,
                          msg=msg)

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)

    def error(self, msg: str) -> None:
        self._emit("error", msg)

    def warn_once(self, key: str, msg: str) -> None:
        """Emit ``msg`` at warn level the first time ``key`` is seen in
        this process; silent afterwards (callers keep counting every
        occurrence through their telemetry counter)."""
        if _tracer.warn_once_key(key):
            self.warn(msg)


_loggers: dict[str, Logger] = {}


def get_logger(component: str) -> Logger:
    log = _loggers.get(component)
    if log is None:
        log = _loggers[component] = Logger(component)
    return log
