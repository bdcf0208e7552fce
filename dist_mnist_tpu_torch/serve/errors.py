"""Router-boundary error taxonomy: every failure a replica attempt can
produce, classified into a retry disposition — by TYPE, never by message.

(Copy of the reference package's `serve/errors.py`; the router that
consumes it joins the port with the fleet slice.)

The train side learned this lesson first (train/loop.py `_is_preemption`):
string-matching exception text turns log-wording changes into behavior
changes and makes adversarial payloads ("user input containing the word
'preempt'") steer control flow. The serving router faces the same choice
on every failed attempt — give up, try again, or declare the replica
dead — so the classification is a single type-first function, unit-pinned
in tests/test_router.py.

Dispositions:

    RETRYABLE      transient: another attempt (same or different replica,
                   after backoff) can succeed. Admission pushback
                   (`QueueFullError`), a draining replica
                   (`ShuttingDownError`), and unrecognized engine errors
                   (the injected `serve_error` model) land here —
                   bounded by the router's attempt budget and the
                   request's deadline.
    TERMINAL       the REQUEST is over: its deadline expired
                   (`DeadlineExceededError`), it was shed, or a hedge
                   loser was cancelled. Retrying spends capacity on an
                   answer nobody is waiting for.
    REPLICA_FATAL  the REPLICA is gone: `ReplicaKilledError` from the
                   fault injector, or any connection-level `OSError`
                   from an HTTP replica. The router marks the replica
                   down and immediately requeues the flight elsewhere —
                   failover, not backoff.

Ordering note: since 3.10 `TimeoutError` IS an `OSError`, so
`DeadlineExceededError` (a `TimeoutError`) must be classified before the
connection-error clause or a dead client request would read as a dead
replica.
"""

from __future__ import annotations

from concurrent.futures import CancelledError

from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    QueueFullError,
    ShuttingDownError,
)

RETRYABLE = "retryable"
TERMINAL = "terminal"
REPLICA_FATAL = "replica_fatal"


class ShedError(RuntimeError):
    """Rejected at the ROUTER boundary: backlog policy shed this request
    (best-effort first) before any replica queue saw it."""


class ReplicaKilledError(RuntimeError):
    """The replica's engine/process is dead — every future call fails.
    Raised by faults.inject.FaultyEngine for a planned
    ``serve_replica_kill`` and by transport shims on connection loss."""


class AllReplicasDownError(RuntimeError):
    """No replica can ever take this request: the whole fleet is down."""


def classify_failure(err: BaseException) -> str:
    """RETRYABLE | TERMINAL | REPLICA_FATAL for one failed attempt."""
    if isinstance(err, DeadlineExceededError):
        return TERMINAL  # before the OSError clause: TimeoutError is OSError
    if isinstance(err, (ShedError, AllReplicasDownError, CancelledError)):
        return TERMINAL
    if isinstance(err, ReplicaKilledError):
        return REPLICA_FATAL
    if isinstance(err, (QueueFullError, ShuttingDownError)):
        return RETRYABLE
    if isinstance(err, (ConnectionError, OSError)):
        return REPLICA_FATAL  # transport-level loss: the replica, not the request
    # unrecognized engine/application error: treat as transient, bounded by
    # the router's attempt budget (the injected serve_error path)
    return RETRYABLE
