"""Local multi-process launcher and supervisor (port of the reference
`cli/launch.py`).

    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 -- \\
        --config=lenet5_fashion --mesh=data=2 --train_steps=500
    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 \\
        --platform=cpu -- --config=lenet5_mnist --train_steps=6
    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 \\
        --max_restarts=2 --elastic --journal=/tmp/j.jsonl \\
        --fault_plan='{"faults": [{"kind": "kill_host", "process": 1,
                                   "step": 35, "recover_after_s": 5}]}' \\
        -- --config=mlp_mnist --checkpoint_dir=/tmp/ckpt

Spawns N identical `cli.train` children (`launch(module=)`: the serving
CLI's tensor-parallel decode spawns `cli.serve` ranks the same way), each
with the coordinator's address (``localhost:<port>``, a port reserved so
that concurrent launchers cannot be handed the same one), its rank and
the world size; streams their interleaved output with a ``[pK]`` prefix
through pump threads named ``LaunchPump-pK``; and on the first abnormal
exit kills the survivors (a dead peer would park them in a collective)
and returns that child's exit status, a signal death normalized to
128+N. `--platform=cpu` runs every rank on the CPU over gloo, each with
one intra-op thread (``OMP_NUM_THREADS=1`` unless the environment sets
it, as torchrun does: N ranks with a pool of every core each would
oversubscribe the host, and under load every op's parallel region then
waits on descheduled threads); otherwise the children take the cards
(`cluster/coordination.py`). A fixed
``--mesh=data=D,model=M,seq=S,pipe=P`` among the train flags must name as
many ranks as `--num_processes`.

The supervisor (`launch(max_restarts=...)`): an abnormal NON-CHIEF death
relaunches the whole world from the checkpoint, with exponential backoff
and jitter, up to `--max_restarts` times; a chief death is fatal; an
operator interrupt is never restarted. `--fault_plan` (forwarded to the
children too) gives it the plan's ``kill_process`` chaos kill, which it
lands in generation 0. A supervised run keeps ONE run journal
(``supervisor_*`` and ``generation_*`` events; the children's own events
land in it through ``DIST_MNIST_TPU_JOURNAL``, with
``DIST_MNIST_TPU_GENERATION`` their generation). `--elastic` turns the
restarts into membership changes (`cluster/membership.py`): a lost
non-chief host is excluded and the next generation re-forms at once
(no backoff, a fresh coordinator port) on the surviving hosts, each
child told its stable ``DIST_MNIST_TPU_HOST_ID`` and the generation's
``DIST_MNIST_TPU_ALIVE_HOSTS``; a shrink below `--min_processes` is
fatal; when a lost host's recovery comes due (a ``kill_host`` fault's
``recover_after_s``, or `--regrow_after_s`) an ``ElasticGrowTimer``
thread drains the generation with SIGTERM (the children checkpoint at a
step boundary and exit 0) and the mesh grows back. Every shrink or grow
is a ``generation_resize`` event.

Every rank of a module launch starts as a stand-by process
(`cli/standby.py`, ``python -m dist_mnist_tpu_torch.cli.standby
<module>``) that imports the rank module and then reads its arguments
and environment on stdin; a rank of generation 0 or of an unsupervised
launch is handed them at once. A supervised run also starts each next
generation's ranks ahead (generation 0's at once, a re-formed
generation's once it has taken its first step: they do not import
inside its recovery window), so a re-formed generation starts at `main`
and does not pay the interpreter's and torch's import inside the
recovery window: the rank's startup clock counts from the hand-off, and
the import it paid before that is the startup record's
``standby_import_ms``. A drained
generation whose every rank has already trained its last step (its
``run_stop`` in the journal, not preempted) ends the run: it is not
grown. Unused stand-bys are killed at the end.

`--compile_cache_dir=DIR` goes on to every child of every generation,
elastic ones included, so a restarted child loads the kernel libraries
its predecessor built (`compilecache/store.py`).

Stated departures: one device per process (`--devices_per_process`
above 1 refuses), so the elastic supervisor passes
``--elastic_baseline_devices=<num_processes>`` to every child; without
`--journal` a supervised run's journal lives in a temp dir of the
supervisor's own, ``dist_mnist_torch_supervisor_*`` under
`tempfile.gettempdir()`, removed at the end. The supervisor injects no
temp compile cache (the reference's ``dist_mnist_warmstart_*``): without
`--compile_cache_dir` the checkout's `build/` already outlives every
generation, warm, and a fresh temp dir would make generation 0 rebuild
every kernel.

`--supervisor_port=P` (with `--elastic`; 0 = a free port) serves the
SUPERVISOR's own `/healthz`, `/metrics` and `/events`
(`obs/exporter.py`): its `HealthState` reads ``training`` while a
generation runs, ``resizing`` (503) during a re-formation, and
``stopped``/``failed`` at the end. Where the forwarded train args carry
``--metrics_port=B`` (rank i of a generation then serves its own
endpoint on B + i), a `FleetScraper` (`obs/fleet.py`) polls every
child, re-targeted at each generation start so the view follows the
resizes: merged ``fleet_*`` histograms and ``fleet/*`` gauges
(straggler detection included) join the supervisor's `/metrics`, and
`/fleet` serves the per-host JSON view.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

#: the temp dir a supervised run without --journal keeps its journal in
SUPERVISOR_DIR_PREFIX = "dist_mnist_torch_supervisor_"

#: children of the running launch; a test asserts it holds no live
#: process after `launch` returns
_LIVE_CHILDREN: list = []

_PORT_LOCK_STALE_SECS = 3600.0


def _port_lock_dir() -> Path:
    return Path(tempfile.gettempdir()) / "dist_mnist_tpu_torch_ports"


def _reserve_port() -> tuple[int, socket.socket, Path]:
    """A free port with a reservation other launchers on this machine
    honor: the probe socket stays bound until the children exist, and an
    O_EXCL lock file named by the port covers the gap until rank 0 binds
    it (removed when the launch ends; stale after an hour)."""
    lock_dir = _port_lock_dir()
    lock_dir.mkdir(exist_ok=True)
    now = time.time()
    for stale in lock_dir.iterdir():
        try:
            if now - stale.stat().st_mtime > _PORT_LOCK_STALE_SECS:
                stale.unlink()
        except OSError:
            pass
    last_err: OSError | None = None
    for _ in range(32):
        s = socket.socket()
        try:
            s.bind(("localhost", 0))
        except OSError as e:
            s.close()
            last_err = e
            continue
        port = s.getsockname()[1]
        lock = lock_dir / str(port)
        try:
            os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return port, s, lock
        except FileExistsError:
            s.close()  # reserved by a concurrent launcher; try another
    raise OSError(
        f"could not reserve a coordinator port after 32 attempts: {last_err}")


def _pump(proc: subprocess.Popen, tag: str) -> None:
    """Prefix-and-forward one child's output."""
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[{tag}] {line.decode(errors='replace')}")
        sys.stdout.flush()


def _normalize_rc(code: int) -> int:
    """A signal death (negative Popen returncode) as the shell's 128+N."""
    return 128 - code if code < 0 else code


def _describe_exit(tag: str, code: int) -> str:
    if code < 0:
        try:
            name = signal.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        return f"{tag} exited rc={_normalize_rc(code)} (killed by {name})"
    return f"{tag} exited rc={code}"


def _say(msg: str) -> None:
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def _child_env() -> dict:
    """The children's environment: this one, with the package's root first
    on PYTHONPATH (so `-m dist_mnist_tpu_torch.cli.train` resolves from
    any working directory)."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _base_env(platform: str | None) -> dict:
    """Every rank's environment before its generation's variables."""
    env = _child_env()
    if platform == "cpu":
        # one intra-op thread a rank (torchrun's default; module docstring)
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _spawn_standbys(n: int, module: str,
                    platform: str | None) -> list[subprocess.Popen]:
    """`n` stand-by ranks of `module` (`cli/standby.py`), importing."""
    procs = []
    for _ in range(n):
        p = subprocess.Popen(
            [sys.executable, "-m", "dist_mnist_tpu_torch.cli.standby",
             module], env=_base_env(platform), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append(p)
        _LIVE_CHILDREN.append(p)
    return procs


def _start_standby(p: subprocess.Popen, argv: list[str],
                   env: dict) -> bool:
    """Hand a stand-by its rank's arguments and environment, stamped with
    the wall time of the hand-off; False when it is gone (the caller
    spawns the rank afresh)."""
    if p.poll() is not None:
        return False
    msg = {"argv": argv, "env": env, "sent": time.time()}
    try:
        p.stdin.write((json.dumps(msg) + "\n").encode())
        p.stdin.close()
    except OSError:
        return False
    return True


def _retire(procs: list[subprocess.Popen]) -> None:
    """Kill and reap processes of this launch, and drop them from
    `_LIVE_CHILDREN`."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
        for pipe in (p.stdin, p.stdout):
            if pipe is not None and not pipe.closed:
                try:
                    pipe.close()
                except OSError:
                    pass
        if p in _LIVE_CHILDREN:
            _LIVE_CHILDREN.remove(p)


class _FirstStepWatch:
    """Tail a run journal for generation `gen`'s ``first_step`` record."""

    def __init__(self, path: str, gen: int):
        self._path, self._gen, self._pos = path, gen, 0

    def seen(self) -> bool:
        try:
            with open(self._path, "rb") as fh:
                fh.seek(self._pos)
                chunk = fh.read()
        except OSError:
            return False
        end = chunk.rfind(b"\n") + 1  # whole lines only
        self._pos += end
        for line in chunk[:end].splitlines():
            if b'"first_step"' not in line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == "first_step" and \
                    rec.get("gen") == self._gen:
                return True
        return False


def _launch_once(
    num_processes: int,
    train_args: list[str],
    *,
    port: int = 0,
    platform: str | None = None,
    module: str = "dist_mnist_tpu_torch.cli.train",
    env_extra: dict[str, str] | None = None,
    kill_spec: tuple[int, float] | None = None,
    child_command: list[str] | None = None,
    journal=None,
    generation: int = 0,
    hosts: list[int] | None = None,
    grow_after_s: float | None = None,
    standbys: list[subprocess.Popen] | None = None,
    prepare_next=None,
    prepare_at_first_step: bool = False,
) -> tuple[int, str | None, int | None, bool]:
    """Spawn ONE cluster generation and wait it out.

    Returns ``(rc, failure, first_dead, grew)``: rc is 0 or the normalized
    exit status of the first abnormal death; `failure` describes that
    death (None on success and on operator interrupt — the supervisor
    must not "restart" a Ctrl-C); `first_dead` is the failing HOST id;
    `grew` is True when the generation was drained on purpose because an
    excluded host's recovery came due.

    `hosts` maps the generation's ranks to stable host ids (rank i is
    host hosts[i], exported as ``DIST_MNIST_TPU_HOST_ID``). `kill_spec` =
    (host id, delay seconds) SIGKILLs that child `delay` seconds after
    spawn (faults/plan.py kill_process). `grow_after_s` arms the elastic
    regrow drain: after that many seconds every child gets SIGTERM.
    `child_command` replaces the stand-by start with a plain ``<command>
    <argv>`` (the supervisor tests' stub children). `standbys`
    (`_spawn_standbys`, spawned ahead) are started as the generation's
    ranks in order, a rank without a live one started through a fresh
    stand-by; `prepare_next()` is called once every rank exists, or with
    `prepare_at_first_step` once `journal` holds this generation's
    ``first_step`` (the supervisor spawns the next generation's stand-bys
    there)."""
    from dist_mnist_tpu_torch.cluster.membership import ENV_HOST_ID

    if hosts is None:
        hosts = list(range(num_processes))
    assert len(hosts) == num_processes
    probe, lock = None, None
    if not port:
        port, probe, lock = _reserve_port()
    standbys = list(standbys or [])
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    timers: list[threading.Thread] = []
    timer_stop = threading.Event()
    grew = threading.Event()
    rc, failure, first_dead = 0, None, None
    try:
        for i in range(num_processes):
            argv = [f"--coordinator_address=localhost:{port}",
                    f"--num_processes={num_processes}",
                    f"--process_id={i}",
                    *([f"--platform={platform}"] if platform else []),
                    *train_args]
            rank_env = {**(env_extra or {}), ENV_HOST_ID: str(hosts[i])}
            if child_command is not None:
                p = subprocess.Popen([*child_command, *argv],
                                     env={**_base_env(platform), **rank_env},
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
                _LIVE_CHILDREN.append(p)
            else:
                p = standbys.pop(0) if standbys else None
                if p is None or not _start_standby(p, argv, rank_env):
                    if p is not None:
                        _retire([p])
                    (p,) = _spawn_standbys(1, module, platform)
                    # a fresh stand-by that dies at once shows as this
                    # rank's death below
                    _start_standby(p, argv, rank_env)
            procs.append(p)
            t = threading.Thread(target=_pump, args=(p, f"p{hosts[i]}"),
                                 name=f"LaunchPump-p{hosts[i]}", daemon=True)
            t.start()
            pumps.append(t)
        if kill_spec is not None and kill_spec[0] in hosts:
            k, delay = kill_spec
            victim = procs[hosts.index(k)]

            def _chaos_kill():
                if timer_stop.wait(delay):
                    return  # the generation ended first
                if victim.poll() is None:
                    _say(f"[launcher] fault injected: SIGKILL p{k} after "
                         f"{delay:.1f}s")
                    if journal is not None:
                        journal.emit("fault_injected", kind="kill_process",
                                     process=k, delay_s=delay, gen=generation)
                    victim.kill()

            timers.append(threading.Thread(
                target=_chaos_kill, name=f"FaultKillTimer-p{k}", daemon=True))
        if grow_after_s is not None:
            g_delay = max(0.05, grow_after_s)

            def _grow_drain():
                if timer_stop.wait(g_delay):
                    return
                live = [p for p in procs if p.poll() is None]
                if not live:
                    return
                # the graceful preemption handshake, not a kill: children
                # checkpoint at a step boundary and exit 0, so the grown
                # generation restores the freshest state
                grew.set()
                _say(f"[launcher] host recovery due: draining generation "
                     f"{generation} ({len(live)} children, SIGTERM) to grow "
                     "the mesh")
                if journal is not None:
                    journal.emit("grow_drain", gen=generation,
                                 children=len(live))
                for p in live:
                    p.send_signal(signal.SIGTERM)

            timers.append(threading.Thread(
                target=_grow_drain, name="ElasticGrowTimer", daemon=True))
        for t in timers:
            t.start()
        # every child exists: release the port for rank 0's store
        if probe is not None:
            probe.close()
            probe = None
        _retire(standbys)  # more stand-bys than ranks (a shrink)
        watch = None
        if prepare_next is not None:
            if prepare_at_first_step and journal is not None:
                watch = _FirstStepWatch(journal.path, generation)
            else:
                prepare_next()
        alive = set(range(num_processes))
        while alive:
            if watch is not None and watch.seen():
                prepare_next()
                watch = None
            dead = []
            for i in sorted(alive):
                code = procs[i].poll()
                if code is None:
                    continue
                alive.discard(i)
                if code != 0:
                    dead.append((i, code))
            if dead and rc == 0:
                # a dying peer takes the chief down with it: blame a
                # non-chief death of the same poll first
                i, code = next(((j, c) for j, c in dead if j != 0), dead[0])
                rc = _normalize_rc(code)
                failure = _describe_exit(f"p{hosts[i]}", code)
                first_dead = hosts[i]
                # SIGKILL, not SIGTERM: the survivors are parked in a
                # collective with a dead peer, and every graceful exit
                # path crosses another one
                _say(f"[launcher] {failure}; killing {len(alive)} peer(s)")
                for j in sorted(alive):
                    procs[j].kill()
            if alive:
                try:
                    procs[min(alive)].wait(timeout=0.5)
                except subprocess.TimeoutExpired:
                    pass
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        deadline = 10.0
        for p in procs:
            try:
                p.wait(timeout=deadline)
            except subprocess.TimeoutExpired:
                deadline = 0.1
        rc, failure, first_dead = 130, None, None
    finally:
        if probe is not None:
            probe.close()
        timer_stop.set()
        for t in timers:
            t.join(timeout=5)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in pumps:
            t.join(timeout=5)
        for p in procs:
            p.wait()
            if p in _LIVE_CHILDREN:
                _LIVE_CHILDREN.remove(p)
        _retire(standbys)
        if lock is not None:
            try:
                lock.unlink()
            except OSError:
                pass
    return rc, failure, first_dead, grew.is_set()


def _generation_finished(journal: str | None, gen: int,
                         world: int) -> bool:
    """Whether every rank of generation `gen` journaled a ``run_stop``
    that is ok and not preempted: the ranks trained the last step (a
    drained rank's ``run_stop`` carries its ``preempted_at``)."""
    from dist_mnist_tpu_torch.obs.events import read_journal

    if not journal:
        return False
    stops = [r for r in read_journal(journal)
             if r.get("event") == "run_stop" and r.get("gen") == gen]
    return len(stops) == world and all(
        r.get("ok") and r.get("preempted_at") is None for r in stops)


def _metrics_port_base(train_args: list[str]) -> int | None:
    """The children's ``--metrics_port`` base from forwarded train args
    (rank i then listens on base + i — cli/train.py main), or None when
    the run exposes no per-process metrics. The last one wins, as in the
    child's parse."""
    value = _flag_value(train_args, "metrics_port")
    try:
        base = int(value) if value is not None else None
    except ValueError:
        return None
    return base if base else None


def launch(num_processes: int, train_args: list[str], *, port: int = 0,
           platform: str | None = None,
           module: str = "dist_mnist_tpu_torch.cli.train",
           env_extra: dict[str, str] | None = None,
           max_restarts: int = 0, restart_backoff_s: float = 1.0,
           kill_spec: tuple[int, float] | None = None,
           child_command: list[str] | None = None,
           journal: str | None = None, elastic: bool = False,
           min_processes: int = 1, regrow_after_s: float = 0.0,
           host_kill: tuple[int, float | None] | None = None,
           compile_cache_dir: str | None = None, health=None,
           supervisor_port: int | None = None,
           fleet_interval_s: float = 1.0) -> int:
    """Spawn the cluster of `module` ranks and wait it out; returns 0 or
    the first abnormal death's normalized exit status. Importable: tests
    call it.

    With ``max_restarts > 0`` (or `elastic`, which implies a budget of
    one resize per host that could be lost) this is the SUPERVISOR of the
    module docstring: restarts with backoff ``restart_backoff_s * 2^k *
    (1 + jitter)`` (a seeded jitter), the chief's death fatal, a Ctrl-C
    never restarted, `kill_spec` landed in generation 0, one run journal
    (`journal`, else one in a temp dir of its own), and under `elastic`
    the membership state machine: a shrink at once on a non-chief death,
    a fatal floor at `min_processes`, and a grow back through a SIGTERM
    drain when a lost host's recovery comes due (``host_kill=(host,
    recover_after_s)`` from a kill_host fault, or `regrow_after_s` for
    any other death). A shrink consumes one of `max_restarts`; a grow
    none. `compile_cache_dir` is forwarded to every child of every
    generation (unless `train_args` already name one); without it
    nothing is injected. Under `elastic`, `supervisor_port` (0 = a free
    port) serves the supervisor's `health` (an `obs.HealthState`, by
    default one made here) and, with ``--metrics_port`` among the train
    args, a `FleetScraper` polling every child each `fleet_interval_s`
    (module docstring)."""
    import random
    import shutil

    from dist_mnist_tpu_torch.cluster.membership import (
        ENV_ALIVE_HOSTS,
        Membership,
    )
    from dist_mnist_tpu_torch.obs import events as events_mod

    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if compile_cache_dir is not None and _flag_value(
            train_args, "compile_cache_dir") is None:
        train_args = [*train_args, f"--compile_cache_dir={compile_cache_dir}"]
    if elastic and max_restarts <= 0:
        max_restarts = max(1, num_processes - 1)
    owned_dir = None
    if journal is None and max_restarts > 0:
        owned_dir = tempfile.mkdtemp(prefix=SUPERVISOR_DIR_PREFIX,
                                     dir=tempfile.gettempdir())
        journal = str(Path(owned_dir) / "journal.jsonl")
    if elastic and child_command is None and not any(
            a.startswith("--elastic_baseline_devices") for a in train_args):
        # the pre-shrink world, so that every (resized) generation resolves
        # the global-batch policy against it: one device per process
        train_args = [*train_args,
                      f"--elastic_baseline_devices={num_processes}"]
    jrnl = events_mod.RunJournal(journal) if journal else None
    if jrnl is not None:
        _say(f"[supervisor] run journal: {journal}")
        jrnl.emit("supervisor_start", num_processes=num_processes,
                  max_restarts=max_restarts, elastic=elastic)
    membership = Membership(num_processes) if elastic else None
    exporter = scraper = None
    metrics_base = _metrics_port_base(train_args)
    if supervisor_port is not None and supervisor_port >= 0 and elastic:
        from dist_mnist_tpu_torch.obs.exporter import (
            HealthState,
            MetricsExporter,
        )

        if health is None:
            health = HealthState()
        if metrics_base:
            # children expose /metrics on metrics_base + rank: the fleet
            # scraper merges them and the supervisor endpoint serves the
            # fleet-wide view (/metrics merged series + /fleet JSON)
            from dist_mnist_tpu_torch.obs.fleet import FleetScraper

            scraper = FleetScraper(journal=jrnl,
                                   interval_s=fleet_interval_s).start()
        exporter = MetricsExporter(
            registry=scraper.registry if scraper is not None else None,
            health=health, journal_path=journal, port=supervisor_port,
            info={"role": "supervisor", "generation": 0},
            fleet=scraper,
        ).start()
        _say(f"[supervisor] health endpoint: {exporter.url('/healthz')}"
             + (f" (fleet view: {exporter.url('/fleet')})"
                if scraper is not None else ""))
    rng = random.Random(0)  # deterministic jitter (tests time the backoff)
    attempt = 0  # failure restarts/resizes consumed (bounded)
    gen = 0  # journal generation number (grows advance it too)
    # the next generation's ranks, importing while this one runs
    spares: list[subprocess.Popen] = []

    def prepare_next() -> None:
        if max_restarts > 0 and child_command is None:
            spares.extend(_spawn_standbys(num_processes, module, platform))

    def _stop(rc: int) -> int:
        if jrnl is not None:
            jrnl.emit("supervisor_stop", rc=rc, restarts=attempt)
        if health is not None:
            health.set("stopped" if rc == 0 else "failed", f"rc={rc}")
        return rc

    try:
        while True:
            hosts = None
            grow_after = None
            if membership is not None:
                now = time.monotonic()
                recovered = membership.restore_due(now)
                if recovered:
                    _say(f"[supervisor] host(s) {recovered} recovered; "
                         f"growing mesh to {membership.world_size}")
                hosts = membership.alive()
                grow_after = membership.next_recovery_in(now)
            world = len(hosts) if hosts is not None else num_processes
            env_gen = dict(env_extra or {})
            if journal:
                env_gen[events_mod.ENV_JOURNAL] = journal
                env_gen[events_mod.ENV_GENERATION] = str(gen)
            # this generation's membership: children read it to decide which
            # peer-ring replica dirs are still reachable after a shrink
            env_gen[ENV_ALIVE_HOSTS] = ",".join(
                str(h) for h in (hosts if hosts is not None
                                 else range(world)))
            if jrnl is not None:
                jrnl.emit("generation_start", gen=gen, world=world,
                          hosts=hosts)
            if health is not None:
                health.set("training", f"gen={gen} world={world}")
            if scraper is not None:
                # rank i listens on metrics_base + i and IS host hosts[i]
                gen_hosts = hosts if hosts is not None else range(world)
                scraper.set_targets({
                    h: f"http://127.0.0.1:{metrics_base + i}"
                    for i, h in enumerate(gen_hosts)})
            if exporter is not None and exporter.info is not None:
                exporter.info["generation"] = gen
            ready, spares[:] = list(spares), []
            rc, failure, first_dead, grew = _launch_once(
                world, train_args, port=port, platform=platform,
                module=module, env_extra=env_gen,
                kill_spec=kill_spec if gen == 0 else None,
                child_command=child_command, journal=jrnl, generation=gen,
                hosts=hosts, grow_after_s=grow_after, standbys=ready,
                prepare_next=prepare_next,
                # a re-formed generation's restore and first step are the
                # recovery window: the next stand-bys import after it
                prepare_at_first_step=gen > 0)
            if jrnl is not None:
                jrnl.emit("generation_end", gen=gen, rc=rc, failure=failure,
                          first_dead=first_dead)
            if rc == 130 and failure is None:
                return _stop(rc)  # operator interrupt: never re-formed
            if grew and membership is not None and \
                    rc in (0, 128 + signal.SIGTERM) and \
                    _generation_finished(journal, gen, world):
                # the drain reached ranks that had already trained the
                # last step (its SIGTERM may land in a rank's teardown):
                # the job is done, nothing is left to grow for
                _say(f"[supervisor] generation {gen} finished the run "
                     "before its drain; not growing")
                return _stop(0)
            if grew and membership is not None:
                # a planned drain to regrow: no failure, no backoff, no
                # restart budget consumed
                due = membership.restore_due(time.monotonic())
                old_world, new_world = world, membership.world_size
                gen += 1
                _say(f"[supervisor] generation resized {old_world} -> "
                     f"{new_world} (grow: host(s) {due} back)")
                if jrnl is not None:
                    jrnl.emit("generation_resize", gen=gen, kind="grow",
                              old_world=old_world, new_world=new_world,
                              host=(due[0] if len(due) == 1 else due))
                if health is not None:
                    health.set("resizing", f"grow {old_world}->{new_world}")
                continue
            if rc == 0 or failure is None or max_restarts <= 0:
                return _stop(rc)
            if first_dead == 0:
                _say(f"[supervisor] chief died ({failure}); fatal — not "
                     f"restarting, rc={rc}")
                return _stop(rc)
            if attempt >= max_restarts:
                _say(f"[supervisor] {failure}; giving up after {attempt} "
                     f"restart(s), rc={rc}")
                return _stop(rc)
            if membership is not None and first_dead is not None:
                # elastic shrink: the lost host is out of the next world,
                # so it re-forms at once (backoff would only add downtime)
                recover = None
                if host_kill is not None and first_dead == host_kill[0]:
                    recover = host_kill[1]
                elif regrow_after_s and regrow_after_s > 0:
                    recover = regrow_after_s
                membership.fail(first_dead, now=time.monotonic(),
                                recover_after_s=recover)
                old_world, new_world = world, membership.world_size
                if new_world < max(1, min_processes):
                    _say(f"[supervisor] {failure}; surviving world size "
                         f"{new_world} below min_processes={min_processes}; "
                         f"fatal, rc={rc}")
                    return _stop(rc)
                attempt += 1
                gen += 1
                _say(f"[supervisor] {failure}; generation resized "
                     f"{old_world} -> {new_world} (shrink: host {first_dead}"
                     f" out"
                     + (f", recovery in {recover:.1f}s" if recover else "")
                     + f") — resize {attempt}/{max_restarts}, no backoff")
                if jrnl is not None:
                    jrnl.emit("generation_resize", gen=gen, kind="shrink",
                              old_world=old_world, new_world=new_world,
                              host=first_dead, recover_after_s=recover,
                              failure=failure)
                if health is not None:
                    health.set("resizing",
                               f"shrink {old_world}->{new_world}")
                continue
            delay = (restart_backoff_s * (2 ** attempt)
                     * (1.0 + 0.5 * rng.random()))
            attempt += 1
            gen += 1
            _say(f"[supervisor] {failure}; restarting cluster (attempt "
                 f"{attempt}/{max_restarts}) in {delay:.2f}s")
            if jrnl is not None:
                jrnl.emit("supervisor_restart", attempt=attempt,
                          delay_s=round(delay, 3), failure=failure)
            time.sleep(delay)
    finally:
        _retire(spares)
        if scraper is not None:
            scraper.close()
        if exporter is not None:
            exporter.close()
        if jrnl is not None:
            jrnl.close()
        if owned_dir is not None:
            shutil.rmtree(owned_dir, ignore_errors=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.cli.launch",
        description="Spawn N ranks of cli.train; train flags go after --.")
    a = p.add_argument
    a("--num_processes", type=int, default=2, help="ranks to spawn")
    a("--port", type=int, default=0,
      help="coordinator port (0 = reserve a free one)")
    a("--platform", default=None, choices=["cpu", "gpu"],
      help="cpu: every rank on the CPU (gloo); default: the cards")
    a("--devices_per_process", type=int, default=1,
      help="refused above 1: one device per process")
    # the supervisor
    a("--max_restarts", type=int, default=0,
      help="on an abnormal NON-CHIEF death, relaunch the world from the "
           "checkpoint with exponential backoff and jitter, up to this many "
           "times; 0 = fail fast")
    a("--restart_backoff_s", type=float, default=1.0,
      help="restart backoff base: attempt k sleeps base * 2^k * "
           "(1 + jitter)")
    a("--elastic", action="store_true",
      help="shrink to survive: exclude a lost non-chief host and re-form "
           "at the surviving world size (no backoff); recovered hosts grow "
           "the mesh back at the next generation boundary")
    a("--min_processes", type=int, default=1,
      help="elastic: the smallest world worth forming; below it is fatal")
    a("--regrow_after_s", type=float, default=0.0,
      help="elastic: re-admit a lost host with no planned recovery this "
           "many seconds after its failure (0 = never)")
    a("--fault_plan", default=None,
      help="fault plan (inline JSON or a path, faults/plan.py): the "
           "launcher lands its kill_process, the supervisor attributes its "
           "kill_host, and the plan goes on to every child")
    a("--journal", default=None,
      help="the run journal (JSONL) of the supervisor and every child; "
           "default: one in a temp dir of the supervisor's own")
    a("--compile_cache_dir", default=None,
      help="the kernel-library store (compilecache/), forwarded to every "
           "child of every generation")
    a("--supervisor_port", type=int, default=None,
      help="elastic: serve the SUPERVISOR's own /healthz, /metrics and "
           "/events on this port (0 = a free one); `resizing` (503) during "
           "a mesh re-formation, and the fleet view (/fleet) when the "
           "train args carry --metrics_port. Unset = no endpoint")
    return p


def _refused(args) -> list[str]:
    out = []
    if args.devices_per_process != 1:
        out.append("--devices_per_process: the port runs one device per "
                   "process (a stated departure)")
    return out


def _flag_value(args: list[str], name: str) -> str | None:
    """The value of ``--name=v`` / ``--name v`` among `args` (the last
    one wins, as in the child's parse), or None."""
    value = None
    for i, arg in enumerate(args):
        if arg.startswith(f"--{name}="):
            value = arg.split("=", 1)[1]
        elif arg == f"--{name}" and i + 1 < len(args):
            value = args[i + 1]
    return value


def mesh_ranks(args: list[str]) -> int | None:
    """The ranks a ``--mesh=k=v,...`` flag among `args` names (the
    product of its axes), or None without a fixed one (no flag, or
    ``data=-1``)."""
    for i, arg in enumerate(args):
        if arg == "--mesh" and i + 1 < len(args):
            arg = "--mesh=" + args[i + 1]
        if arg.startswith("--mesh="):
            axes = dict(part.split("=") for part in arg[7:].split(","))
            sizes = [int(v) for v in axes.values()]
            if int(axes.get("data", -1)) == -1:
                return None
            out = 1
            for n in sizes:
                out *= n
            return out
    return None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        cut = argv.index("--")
        own, train_args = argv[:cut], argv[cut + 1:]
    else:
        own, train_args = argv, []
    args = build_parser().parse_args(own)
    refused = _refused(args)
    want = mesh_ranks(train_args)
    if want is not None and want != args.num_processes:
        refused.append(f"--mesh names {want} ranks (data x model x seq x "
                       f"pipe) but --num_processes={args.num_processes}")
    kill_spec = host_kill = None
    spec = args.fault_plan or _flag_value(train_args, "fault_plan")
    if spec:
        from dist_mnist_tpu_torch.faults.plan import FaultPlan

        try:
            plan = FaultPlan.from_spec(spec)
        except (OSError, ValueError, TypeError) as err:
            refused.append(f"--fault_plan: {err}")
        else:
            # one plan, two layers: the launcher lands the process kill and
            # attributes the host loss; the children take the in-loop kinds
            kill_spec = plan.kill_spec()
            host_kill = plan.host_kill_spec()
            if _flag_value(train_args, "fault_plan") is None:
                train_args = [*train_args, f"--fault_plan={plan.to_json()}"]
    if refused:
        raise SystemExit("error: " + "; ".join(refused))
    return launch(args.num_processes, train_args, port=args.port,
                  platform=args.platform, max_restarts=args.max_restarts,
                  restart_backoff_s=args.restart_backoff_s,
                  kill_spec=kill_spec, journal=args.journal,
                  elastic=args.elastic, min_processes=args.min_processes,
                  regrow_after_s=args.regrow_after_s, host_kill=host_kill,
                  compile_cache_dir=args.compile_cache_dir,
                  supervisor_port=args.supervisor_port)


if __name__ == "__main__":
    sys.exit(main())
