"""Fault plans: a deterministic, serializable schedule of injected faults.

The reference validated its preemption ring by hand-injecting
AbortedError into `_RecoverableSession` in unit tests (SURVEY.md §4);
nothing exercised the launch or checkpoint layers. A `FaultPlan` makes
every recovery path in this repo reachable on purpose, from a test, a
bench run, or the CLI (``--fault_plan``), with no real hardware fault:

=================== ========================== ==========================
kind                trigger                    consumed by
=================== ========================== ==========================
preempt             loop step >= ``step``      FaultInjectionHook (raises
                                               PreemptionError inside the
                                               loop's recovery try)
corrupt_checkpoint  restore while step ``step``FaultyCheckpointManager
                    is on disk                 (truncates/deletes payload)
stall_input         loop step >= ``step``      FaultyBatches (sleeps
                                               ``seconds`` in the feed)
kill_process        ``after_s`` after spawn    cli/launch.py supervisor
                                               (SIGKILLs child ``process``)
kill_host           loop step >= ``step``,     FaultInjectionHook on the
                    generation 0 only          victim (SIGKILLs ITSELF) +
                                               cli/launch.py --elastic
                                               (excludes the host from
                                               later generations until
                                               ``recover_after_s`` elapses)
serve_error         predict call >= ``request``FaultyEngine (raises into
                                               the DynamicBatcher)
serve_replica_kill  predict call >= ``request``FaultyEngine on replica
                    on replica ``replica``     ``replica`` (engine goes
                                               PERMANENTLY dead: every
                                               later predict raises
                                               ReplicaKilledError — the
                                               router must fail over)
serve_replica_stall predict call >= ``request``FaultyEngine on replica
                    on replica ``replica``     ``replica`` (sleeps
                                               ``seconds`` once — the
                                               router's hedge trigger)
=================== ========================== ==========================

``kill_host`` vs ``kill_process``: a kill_process is a transient crash —
the same process index comes back in the next (full-size) generation. A
kill_host models permanent host loss: the victim dies at an exact step
(deterministic against import/compile time variance, and only in
generation 0 so restore+replay never re-fires it), and the elastic
supervisor excludes that host from every following generation until its
planned recovery — ``recover_after_s`` wall seconds after the failure is
observed (None = never), at which point the next generation boundary grows
the mesh back.

Every fault fires AT MOST ONCE (`fired` latches), so a replayed step
range after a restore does not re-trigger the same fault — which is what
makes trajectory-identity assertions possible. One plan can be shared by
all layers: each consumer takes only its kinds, so a single
``--fault_plan`` JSON drives the launcher's kill AND the children's
in-loop faults (the flag is forwarded like any train flag).

Wiring helpers (`hook()`, `wrap_batches()`, ...) import faults.inject
lazily so this module stays importable without jax-adjacent code.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

KINDS = (
    "preempt",
    "corrupt_checkpoint",
    "stall_input",
    "kill_process",
    "kill_host",
    "serve_error",
    "serve_replica_kill",
    "serve_replica_stall",
)


@dataclasses.dataclass
class Fault:
    kind: str
    step: int | None = None  # preempt/stall trigger; corrupt target step
    seconds: float | None = None  # stall_input duration
    process: int | None = None  # kill_process target index
    after_s: float | None = None  # kill_process delay after spawn
    request: int | None = None  # serve_error predict-call ordinal (0-based)
    replica: int | None = None  # serve_replica_* target replica id
    recover_after_s: float | None = None  # kill_host: planned recovery delay
    mode: str = "truncate"  # corrupt_checkpoint: truncate | delete
    fired: bool = False  # latched by the consumer on injection

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {KINDS}"
            )

    # -- constructors (the readable way to build plans in code) -------------

    @classmethod
    def preempt(cls, step: int) -> "Fault":
        return cls("preempt", step=step)

    @classmethod
    def corrupt_checkpoint(cls, step: int, mode: str = "truncate") -> "Fault":
        return cls("corrupt_checkpoint", step=step, mode=mode)

    @classmethod
    def stall_input(cls, step: int, seconds: float) -> "Fault":
        return cls("stall_input", step=step, seconds=seconds)

    @classmethod
    def kill_process(cls, process: int, after_s: float = 0.0) -> "Fault":
        return cls("kill_process", process=process, after_s=after_s)

    @classmethod
    def kill_host(
        cls,
        process: int,
        step: int,
        recover_after_s: float | None = None,
    ) -> "Fault":
        """Permanent loss of host ``process`` at train step ``step``;
        re-admitted ``recover_after_s`` seconds after the failure is seen
        by the supervisor (None = stays out for the whole run)."""
        return cls(
            "kill_host",
            process=process,
            step=step,
            recover_after_s=recover_after_s,
        )

    @classmethod
    def serve_error(cls, request: int = 0) -> "Fault":
        return cls("serve_error", request=request)

    @classmethod
    def serve_replica_kill(cls, replica: int, request: int = 0) -> "Fault":
        """Replica ``replica``'s engine dies permanently on predict call
        ``request`` (its ordinal, not the fleet's) — every later predict
        raises ReplicaKilledError, like a device loss under a live server."""
        return cls("serve_replica_kill", replica=replica, request=request)

    @classmethod
    def serve_replica_stall(cls, replica: int, seconds: float,
                            request: int = 0) -> "Fault":
        """Replica ``replica`` sleeps ``seconds`` inside predict call
        ``request`` (once) — a straggler, not a death; what a router's
        hedged requests are for."""
        return cls("serve_replica_stall", replica=replica, seconds=seconds,
                   request=request)

    def to_dict(self) -> dict:
        out = {"kind": self.kind}
        for field in (
            "step",
            "seconds",
            "process",
            "after_s",
            "request",
            "replica",
            "recover_after_s",
        ):
            v = getattr(self, field)
            if v is not None:
                out[field] = v
        if self.kind == "corrupt_checkpoint":
            out["mode"] = self.mode
        return out


class FaultPlan:
    """An ordered set of `Fault`s plus a seed (for consumers that need
    randomness, e.g. the supervisor's restart jitter)."""

    def __init__(self, faults=(), *, seed: int = 0):
        self.faults: list[Fault] = [
            f if isinstance(f, Fault) else Fault(**f) for f in faults
        ]
        self.seed = seed

    # -- (de)serialization: --fault_plan takes inline JSON or a file path --

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        if not isinstance(obj, dict):
            raise ValueError("fault plan JSON must be an object")
        return cls(obj.get("faults", ()), seed=obj.get("seed", 0))

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        spec = spec.strip()
        if not spec:
            return cls()
        if spec.startswith("{"):
            return cls.from_json(spec)
        return cls.from_json(Path(spec).read_text())

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [f.to_dict() for f in self.faults]}
        )

    # -- consumer queries ---------------------------------------------------

    def pending(self, kind: str) -> list[Fault]:
        return [f for f in self.faults if f.kind == kind and not f.fired]

    def fired(self) -> list[Fault]:
        return [f for f in self.faults if f.fired]

    def kill_spec(self) -> tuple[int, float] | None:
        """(process index, delay seconds) of the first pending kill fault —
        the launcher-level injection (cli/launch.py); None when the plan
        has none. NOT latched here: the launcher marks it fired when the
        kill actually lands."""
        for f in self.pending("kill_process"):
            return f.process or 0, f.after_s or 0.0
        return None

    def host_kill_spec(self) -> tuple[int, float | None] | None:
        """(host id, recover_after_s) of the first pending kill_host —
        the ATTRIBUTION side for the elastic supervisor (the kill itself
        lands in-child via FaultInjectionHook at the fault's step). Not
        latched: the victim latches its own copy of the plan when it
        fires."""
        for f in self.pending("kill_host"):
            return f.process or 0, f.recover_after_s
        return None

    # -- wiring helpers (lazy imports; see faults/inject.py) ----------------

    def hook(self):
        """The in-loop injector (preempt faults) as a train-loop Hook."""
        from dist_mnist_tpu_torch.faults.inject import FaultInjectionHook

        return FaultInjectionHook(self)

    def wrap_batches(self, batches):
        if not self.pending("stall_input"):
            return batches
        from dist_mnist_tpu_torch.faults.inject import FaultyBatches

        return FaultyBatches(batches, self)

    def wrap_checkpoint_manager(self, manager):
        if manager is None or not self.pending("corrupt_checkpoint"):
            return manager
        from dist_mnist_tpu_torch.faults.inject import FaultyCheckpointManager

        return FaultyCheckpointManager(manager, self)

    def wrap_engine(self, engine, *, replica_id: int | None = None):
        """Wrap a serve engine when any serve-side fault is pending.
        ``replica_id`` scopes the replica-targeted kinds: a fleet shares
        ONE plan, and each replica's engine consumes only the faults whose
        ``replica`` matches (plain ``serve_error`` matches any)."""
        if not any(
            self.pending(k)
            for k in ("serve_error", "serve_replica_kill",
                      "serve_replica_stall")
        ):
            return engine
        from dist_mnist_tpu_torch.faults.inject import FaultyEngine

        return FaultyEngine(engine, self, replica_id=replica_id)

    def wrap_step_fn(self, step_fn, *, initial_step: int = 0):
        from dist_mnist_tpu_torch.faults.inject import FaultyStepFn

        return FaultyStepFn(step_fn, self, initial_step=initial_step)
