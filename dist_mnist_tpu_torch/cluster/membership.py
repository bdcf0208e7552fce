"""Elastic cluster membership: which hosts may join the next generation.

The supervisor (`cli/launch.py --elastic`) treats each launch generation as
a membership snapshot: host ids are STABLE labels 0..N-1 assigned at
supervisor start, while process ranks are assigned per generation by
position in the surviving-host list. Host 0 is the chief; its death is
always fatal (it owns the run directory and checkpoint commits), so host 0
can never be excluded here.

A host that dies abnormally is `fail()`ed out of the membership, optionally
with a recovery deadline (`recover_after_s` wall seconds from the failure).
`due(now)` lists hosts whose deadline has passed — the supervisor restores
them at the next generation boundary and grows the mesh back. A deadline of
None means the host never auto-recovers (permanent loss, e.g. a seeded
`kill_host` fault with no planned recovery).

Time is always injected (`now`) so the resize/regrow decision sequence is
unit-testable without sleeping.
"""

from __future__ import annotations

# Per-child env var carrying the stable host id across generations (the
# rank, by contrast, is positional and changes when the mesh resizes).
ENV_HOST_ID = "DIST_MNIST_TPU_HOST_ID"

# Per-generation env var: comma-separated stable host ids admitted to THIS
# generation (the supervisor's membership.alive() at launch). Children use
# it to decide which peer-ring replica dirs are reachable after a shrink —
# a dead host's local disk is gone with it (checkpoint/peer.py).
ENV_ALIVE_HOSTS = "DIST_MNIST_TPU_ALIVE_HOSTS"


def ring_peer(host: int, hosts) -> int | None:
    """The ring neighbor that holds `host`'s replica shards: the next id in
    the sorted host list, wrapping. None when `host` is alone (a 1-host
    world has no distinct peer) or not a member."""
    ring = sorted(set(hosts))
    if host not in ring or len(ring) < 2:
        return None
    return ring[(ring.index(host) + 1) % len(ring)]


class Membership:
    """Tracks alive/excluded hosts and their recovery deadlines."""

    def __init__(self, num_hosts: int):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self.num_hosts = num_hosts
        # host id -> recovery deadline (absolute seconds) or None = never
        self._excluded: dict[int, float | None] = {}

    # -- queries ----------------------------------------------------------

    def alive(self) -> list[int]:
        """Sorted host ids eligible for the next generation."""
        return [h for h in range(self.num_hosts) if h not in self._excluded]

    @property
    def world_size(self) -> int:
        return self.num_hosts - len(self._excluded)

    def is_alive(self, host: int) -> bool:
        return 0 <= host < self.num_hosts and host not in self._excluded

    def rank_of(self, host: int) -> int | None:
        """Positional rank of `host` in the next generation (None if dead)."""
        alive = self.alive()
        return alive.index(host) if host in alive else None

    def due(self, now: float) -> list[int]:
        """Excluded hosts whose recovery deadline has passed."""
        return sorted(
            h
            for h, deadline in self._excluded.items()
            if deadline is not None and now >= deadline
        )

    def next_recovery_in(self, now: float) -> float | None:
        """Seconds until the earliest pending recovery (None if nothing
        will ever recover). Clamped at 0 for already-due hosts."""
        deadlines = [d for d in self._excluded.values() if d is not None]
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - now)

    # -- transitions ------------------------------------------------------

    def fail(
        self, host: int, *, now: float, recover_after_s: float | None = None
    ) -> None:
        """Exclude `host` from future generations.

        `recover_after_s` schedules automatic re-admission that many wall
        seconds from `now`; None means the host stays out until an explicit
        `restore()`.
        """
        if host == 0:
            raise ValueError("host 0 is the chief and cannot be excluded")
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} out of range [0, {self.num_hosts})")
        self._excluded[host] = (
            None if recover_after_s is None else now + recover_after_s
        )

    def restore(self, host: int) -> None:
        """Re-admit a host (no-op if already alive)."""
        self._excluded.pop(host, None)

    def restore_due(self, now: float) -> list[int]:
        """Re-admit every host whose deadline has passed; returns them."""
        due = self.due(now)
        for h in due:
            self.restore(h)
        return due

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Membership(alive={self.alive()}, "
            f"excluded={sorted(self._excluded)})"
        )
