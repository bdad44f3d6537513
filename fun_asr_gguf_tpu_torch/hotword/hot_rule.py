# coding: utf-8
"""Regex rule-based correction.

Behavioral equivalent of the reference RuleCorrector
(``fun_asr_gguf/hotword/hot_rule.py``): "pattern = replacement" lines,
thread-safe hot-swappable rule set, invalid patterns skipped silently.
Wired opt-in through the engine's ``rules_path`` (the reference ships
the class unwired). ``correct`` aliases ``substitute`` — the reference's
``__main__`` demo calls a ``correct`` API its class never defines.

Unlike the reference (which re-parses and try/excepts every pattern on
every call), rules compile ONCE at update time; ``substitute`` just runs
the compiled chain.
"""

import re
from threading import Lock
from typing import Iterator, List, Tuple


class RuleCorrector:
    """Exact regex substitution rules, applied in file order."""

    def __init__(self):
        self._rules: List[Tuple[re.Pattern, str]] = []
        self._lock = Lock()

    @staticmethod
    def _parse(rule_text: str) -> Iterator[Tuple[str, str]]:
        for raw in rule_text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.count(" = ") != 1:    # ambiguous lines are skipped
                continue
            pattern, _, replacement = line.partition(" = ")
            yield pattern.strip(), replacement.strip()

    def update_rules(self, rule_text: str) -> int:
        """Replace the rule set (thread-safe). Returns the number of
        rules that compiled; malformed regexes are dropped here so the
        substitution hot path never sees them."""
        compiled = []
        for pattern, replacement in self._parse(rule_text):
            try:
                compiled.append((re.compile(pattern), replacement))
            except re.error:
                pass
        with self._lock:
            self._rules = compiled
        return len(compiled)

    @property
    def patterns(self) -> dict:
        """{pattern: replacement} view of the compiled rule set."""
        with self._lock:
            return {rx.pattern: repl for rx, repl in self._rules}

    def substitute(self, text: str) -> str:
        if not text:
            return text
        with self._lock:
            rules = self._rules
        for rx, replacement in rules:
            try:
                text = rx.sub(replacement, text)
            except re.error:
                # bad group reference in the replacement template only
                # surfaces on first match — skip that rule, keep going
                pass
        return text

    correct = substitute
