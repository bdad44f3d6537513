# coding: utf-8
"""Hotword manager: loading, live file-watching, singleton access.

Behavioral port of the reference HotwordManager
(``fun_asr_gguf/hotword/manager.py``): loads ``hot.txt`` (auto-creating a
template when missing), exposes the corrector, and hot-reloads on file
change with a 3 s debounce. The reference's watchdog Observer is replaced
by a 1 s mtime-polling daemon thread — same debounce semantics, zero
dependencies (watchdog is used instead when installed).
"""

from __future__ import annotations

import threading
import time
import unicodedata
from pathlib import Path
from typing import Any, Optional

from . import logger
from .hot_phoneme import PhonemeCorrector

try:
    from rich.console import Console
    console = Console(highlight=False)
    def _status(msg):
        console.print(msg)
except ImportError:  # pragma: no cover
    def _status(msg):
        print(msg)

_manager: Optional["HotwordManager"] = None

_DEBOUNCE_SECONDS = 3.0
_POLL_SECONDS = 1.0


def read_or_create_text(path, template: str):
    """Read a user-editable text file; create it (with parents) from
    ``template`` when missing. Fault-tolerant: IO errors log and return
    ``None`` (distinguishable from a genuinely empty file's ``""`` — a
    transient error, e.g. an editor's atomic-save window, must NOT be
    treated as "the user emptied the file"), stray non-UTF-8 bytes are
    replaced — a correction/hotword file must never take down engine init
    or a reload (shared by hot.txt, rules_path and rectify-history
    loading)."""
    path = Path(path)
    try:
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(template, encoding="utf-8")
            return ""
        return path.read_text(encoding="utf-8", errors="replace")
    except OSError as e:
        logger.error("failed reading %s: %s", path, e)
        return None


class _PollingWatcher:
    """mtime-polling file watcher with debounce (watchdog replacement).

    Public alias: :data:`PollingWatcher` — also used by the engine's
    rules/rectify live-reload wiring (core/model_manager.py).
    """

    def __init__(self, path: Path, callback):
        self.path = path
        self.callback = callback
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2 * _POLL_SECONDS + 0.5)

    def _mtime(self):
        try:
            return self.path.stat().st_mtime
        except OSError:
            return None

    def _run(self):
        last = self._mtime()
        pending_since = None
        while not self._stop.wait(_POLL_SECONDS):
            now_m = self._mtime()
            if now_m != last:
                last = now_m
                pending_since = time.time()
                logger.debug("hotword file changed: %s", self.path.name)
            if pending_since is not None and \
                    time.time() - pending_since >= _DEBOUNCE_SECONDS:
                pending_since = None
                try:
                    self.callback()
                    logger.info("hotword file auto-reloaded: %s",
                                self.path.name)
                except Exception as e:
                    logger.error("hotword reload failed: %s", e, exc_info=True)


class HotwordManager:
    """Owns the corrector + the hot.txt watcher."""

    def __init__(self, hotword_file: Optional[Path] = None,
                 threshold: float = 0.7,
                 similar_threshold: Optional[float] = None):
        self.file = Path(hotword_file) if hotword_file else Path("hot.txt")
        self.threshold = threshold
        self.similar_threshold = similar_threshold
        self.phoneme_corrector = PhonemeCorrector(
            threshold=threshold, similar_threshold=similar_threshold)
        self._watcher: Optional[Any] = None

    @staticmethod
    def _display_width(text: str) -> int:
        return sum(2 if unicodedata.east_asian_width(c) in ("W", "F", "A")
                   else 1 for c in text)

    def _format_msg(self, label: str, filename: str, count: int) -> str:
        pad1 = " " * max(0, 6 - self._display_width(label))
        pad2 = " " * max(0, 8 - self._display_width(filename))
        return (f"[bold cyan]      {label}{pad1}：[/][cyan]{filename}{pad2}[/]"
                f" 已更新[green]{count:3d}[/]条")

    def load(self) -> None:
        logger.info("loading hotword resources...")
        self._load_hot()
        logger.info("hotword resources loaded")

    def _read_file(self) -> str:
        return read_or_create_text(self.file, "# 热词文件单行一个\n")

    def _load_hot(self) -> None:
        content = self._read_file()
        if content is None:     # transient read error: keep current words
            return
        num = self.phoneme_corrector.update_hotwords(content)
        _status(self._format_msg("热词库", self.file.name, num))

    def get_corrector(self) -> PhonemeCorrector:
        return self.phoneme_corrector

    def start_file_watcher(self):
        if self._watcher:
            return self._watcher
        self._watcher = _PollingWatcher(self.file, self._load_hot)
        self._watcher.start()
        logger.debug("hotword file watcher started: %s", self.file)
        return self._watcher

    def stop_file_watcher(self) -> None:
        if self._watcher:
            self._watcher.stop()
            self._watcher = None
            logger.debug("hotword file watcher stopped")


def get_hotword_manager(hotword_file: Optional[Path] = None,
                        threshold: float = 0.7,
                        similar_threshold: Optional[float] = None
                        ) -> HotwordManager:
    """Singleton accessor; first call fixes the configuration."""
    global _manager
    if _manager is None:
        _manager = HotwordManager(hotword_file=hotword_file,
                                  threshold=threshold,
                                  similar_threshold=similar_threshold)
    return _manager


def reset_hotword_manager() -> None:
    """Testing hook: drop the singleton (stops any watcher)."""
    global _manager
    if _manager is not None:
        _manager.stop_file_watcher()
        _manager = None


# public name for reuse outside the hotword package
PollingWatcher = _PollingWatcher
