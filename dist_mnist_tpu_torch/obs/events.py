"""Structured run journal: append-only JSONL lifecycle record.

One journal file records a whole run — across processes and across
supervisor restart generations. Every record is a single JSON line

    {"seq": n, "ts": <unix>, "pid": <pid>, "gen": <generation>,
     "host": <host_id, when known>, "event": "<name>", ...fields}

``host`` is the stable elastic-membership host id (set by the
supervisor via ``DIST_MNIST_TPU_HOST_ID``): unlike ``pid`` it survives
generation rollover, which is what lets scripts/fleet_trace.py keep one
timeline track per host across a resize.

``seq`` is monotonic per (pid, generation); ``(pid, gen, seq)`` is a
total order key within one process's lifetime. Writes go through an
``O_APPEND`` fd with one ``os.write`` per record: on POSIX, appends
under ``PIPE_BUF`` bytes are atomic, so the supervisor and its child
processes share one file without interleaving torn lines.

The module-level *current journal* lets deep subsystems (checkpoint
manager, fault injectors, compile cache, the autotuner's ``tuning/*``
family — search trials, winners, applied knobs, stale keys) emit events
without threading a journal handle through every constructor:
``events.emit(...)`` is a no-op unless someone installed a journal via
``set_journal``.

Stdlib-only on purpose: importable from the supervisor and from any
process before torch/numpy are up. (A copy of the reference's
`obs/events.py`.)
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

__all__ = [
    "RunJournal", "set_journal", "get_journal", "emit",
    "read_journal", "tail_journal",
    "ENV_JOURNAL", "ENV_GENERATION", "ENV_HOST_ID",
]

# Env vars the supervisor sets so every child generation lands in the
# supervisor-owned journal (as an explicit --compile_cache_dir is
# forwarded to each of them).
ENV_JOURNAL = "DIST_MNIST_TPU_JOURNAL"
ENV_GENERATION = "DIST_MNIST_TPU_GENERATION"
# Stable host identity across generations. Defined (with the same
# value) in cluster/membership.py; duplicated here so the journal
# stays importable without pulling the cluster package.
ENV_HOST_ID = "DIST_MNIST_TPU_HOST_ID"


class RunJournal:
    """Append-only JSONL event sink. Thread-safe; multi-process-safe on
    POSIX for records under PIPE_BUF (ours are tiny)."""

    def __init__(self, path, *, generation: int = 0,
                 host_id: int | None = None):
        self.path = os.fspath(path)
        self.generation = int(generation)
        if host_id is None:
            env_host = os.environ.get(ENV_HOST_ID)
            host_id = int(env_host) if env_host is not None else None
        # stable host id (survives generation rollover); None for
        # single-process runs and the supervisor itself
        self.host_id = host_id
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._seq = 0
        self._lock = threading.Lock()
        self._closed = False

    def emit(self, event: str, **fields) -> dict:
        rec = {"seq": 0, "ts": time.time(), "pid": os.getpid(),
               "gen": self.generation, "event": str(event)}
        if self.host_id is not None:
            rec["host"] = self.host_id
        rec.update(fields)
        with self._lock:
            if self._closed:
                return rec
            rec["seq"] = self._seq
            self._seq += 1
            line = json.dumps(rec, sort_keys=False,
                              separators=(",", ":"), default=str) + "\n"
            os.write(self._fd, line.encode("utf-8"))
        return rec

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"RunJournal({self.path!r}, gen={self.generation})"


# -- module-level current journal ---------------------------------------------

_CURRENT: RunJournal | None = None


def set_journal(journal: RunJournal | None) -> RunJournal | None:
    """Install the process-wide journal; returns the previous one so
    callers can restore it (``prev = set_journal(j) ... set_journal(prev)``)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = journal
    return prev


def get_journal() -> RunJournal | None:
    return _CURRENT


def emit(event: str, **fields) -> None:
    """Emit to the current journal; silently no-op when none is installed.
    Never raises: telemetry must not take down the run it is recording."""
    j = _CURRENT
    if j is None:
        return
    try:
        j.emit(event, **fields)
    except Exception:  # noqa: BLE001 - observability is best-effort
        log.warning("journal emit failed for event %r", event, exc_info=True)


# -- reading ------------------------------------------------------------------

def read_journal(path) -> list[dict]:
    """Parse a journal file; skips torn/invalid trailing lines."""
    out: list[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    log.warning("skipping malformed journal line: %.80s", line)
    except FileNotFoundError:
        return []
    return out


def tail_journal(path, n: int = 50) -> list[dict]:
    recs = read_journal(path)
    return recs[-n:] if n >= 0 else recs
