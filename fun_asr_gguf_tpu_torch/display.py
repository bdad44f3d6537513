"""Async console display.

Role parity with the reference's background console printer
(``fun_asr_gguf/display.py``): terminal IO must never stall the decode
path, streamed token chunks print inline, long-audio segments get an
``[i/N]`` prefix, and a ``skip_technical`` switch silences per-stage
chatter.

Design: instead of a message-type queue loop, writes are *closures*
serialized through a single daemon worker draining a deque under a
condition variable. The worker owns all stdout state (including the
"was mid-stream, need a newline" bit), so callers never synchronize on
anything but the deque append.
"""

import sys
import threading
from collections import deque

_STOP = object()


class _SerialWriter:
    """Runs queued zero-arg callables in order on one daemon thread."""

    def __init__(self):
        self._work = deque()
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="display-writer")
        self._thread.start()

    def post(self, fn):
        with self._cv:
            self._work.append(fn)
            self._cv.notify()

    def close(self, timeout: float = 1.0):
        if not self._thread.is_alive():
            return
        self.post(_STOP)
        self._thread.join(timeout=timeout)

    def _drain(self):
        while True:
            with self._cv:
                while not self._work:
                    self._cv.wait()
                fn = self._work.popleft()
            if fn is _STOP:
                return
            try:
                fn()
            except Exception:
                pass            # console IO must never kill the pipeline


class DisplayReporter:
    """Non-blocking console reporter with streaming-token support.

    ``on_stream(piece)`` / ``on_stream_reset()`` are optional callbacks
    powering the server's SSE mode; they fire on the *caller's* thread so
    network consumers see pieces in submission order.
    """

    def __init__(self, verbose: bool = True, on_stream=None,
                 on_stream_reset=None):
        self.verbose = verbose
        self.on_stream = on_stream
        self.on_stream_reset = on_stream_reset
        self.skip_technical = False
        self._segment = (0, 0)          # (index, total) for [i/N] prefixes
        self._writer = _SerialWriter()
        self._mid_stream = False        # owned by the writer thread

    # -- caller-side API ----------------------------------------------------

    def print(self, message: str, force: bool = False):
        if not self.verbose or (self.skip_technical and not force):
            return
        idx, total = self._segment     # snapshot now: async print must not
        prefix = f"[{idx}/{total}] " if total > 1 and idx > 0 else ""
        self._writer.post(lambda: self._emit_line(prefix + message))

    def stream(self, chunk: str):
        if self.on_stream is not None:
            self.on_stream(chunk)
        if self.verbose:
            self._writer.post(lambda: self._emit_chunk(chunk))

    def stream_reset(self):
        """Previously streamed pieces are being discarded (repetition-fuse
        retry): SSE consumers should clear their buffer. The console keeps
        what it printed — the retry banner marks it."""
        if self.on_stream_reset is not None:
            self.on_stream_reset()

    def set_segment(self, current: int, total: int):
        self._segment = (current, total)

    @property
    def current_segment(self):
        return self._segment

    def stop(self):
        self._writer.post(self._finish_stream_line)
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    # -- writer-thread side ---------------------------------------------------

    def _emit_line(self, text: str):
        self._finish_stream_line()
        sys.stdout.write(text + "\n")
        sys.stdout.flush()

    def _emit_chunk(self, chunk: str):
        sys.stdout.write(chunk)
        sys.stdout.flush()
        self._mid_stream = True

    def _finish_stream_line(self):
        if self._mid_stream:
            sys.stdout.write("\n")
            sys.stdout.flush()
            self._mid_stream = False
