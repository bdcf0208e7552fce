"""Local multi-process launcher (port of the core of the reference
`cli/launch.py`).

    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 -- \\
        --config=lenet5_fashion --mesh=data=2 --train_steps=500
    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 \\
        --platform=cpu -- --config=lenet5_mnist --train_steps=6

Spawns N identical `cli.train` children (`launch(module=)`: the serving
CLI's tensor-parallel decode spawns `cli.serve` ranks the same way), each
with the coordinator's
address (``localhost:<port>``, a port reserved so that concurrent
launchers cannot be handed the same one), its rank and the world size;
streams their interleaved output with a ``[pK]`` prefix through pump
threads named ``LaunchPump-pK``; and on the first abnormal exit kills the
survivors (a dead peer would park them in a collective) and returns that
child's exit status, a signal death normalized to 128+N. `--platform=cpu`
runs every rank on the CPU over gloo; otherwise the children take the
cards (`cluster/coordination.py`). A fixed
``--mesh=data=D,model=M,seq=S,pipe=P`` among the train flags must name as
many ranks as `--num_processes`.

The reference's supervisor (restarts, `--elastic` resizing, chaos kills,
the warm-start compile cache, the run journal and the supervisor's HTTP
endpoint, with `cluster/membership.py`) refuses, naming ROADMAP §1 item
13. One device per process: `--devices_per_process` above 1 refuses.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

_RESILIENCE = "ROADMAP §1 item 13 (resilience, async I/O, overlap)"

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


def launch(num_processes: int, train_args: list[str], *, port: int = 0,
           platform: str | None = None,
           module: str = "dist_mnist_tpu_torch.cli.train") -> int:
    """Spawn the cluster of `module` ranks and wait it out; returns 0 or
    the first abnormal death's normalized exit status. Importable: tests
    call it."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    probe, lock = None, None
    if not port:
        port, probe, lock = _reserve_port()
    env = _child_env()
    prefix = [sys.executable, "-m", module]
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    rc = 0
    try:
        for i in range(num_processes):
            cmd = [*prefix,
                   f"--coordinator_address=localhost:{port}",
                   f"--num_processes={num_processes}",
                   f"--process_id={i}",
                   *([f"--platform={platform}"] if platform else []),
                   *train_args]
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs.append(p)
            _LIVE_CHILDREN.append(p)
            t = threading.Thread(target=_pump, args=(p, f"p{i}"),
                                 name=f"LaunchPump-p{i}", daemon=True)
            t.start()
            pumps.append(t)
        # every child exists: release the port for rank 0's store
        if probe is not None:
            probe.close()
            probe = None
        alive = set(range(num_processes))
        while alive:
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
                _say(f"[launcher] {_describe_exit(f'p{i}', code)}; killing "
                     f"{len(alive)} peer(s)")
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
        rc = 130
    finally:
        if probe is not None:
            probe.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in pumps:
            t.join(timeout=5)
        for p in procs:
            p.wait()
            if p in _LIVE_CHILDREN:
                _LIVE_CHILDREN.remove(p)
        if lock is not None:
            try:
                lock.unlink()
            except OSError:
                pass
    return rc


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
    # the reference's supervisor: refused
    a("--max_restarts", type=int, default=0, help=_RESILIENCE)
    a("--restart_backoff_s", type=float, default=None, help=_RESILIENCE)
    a("--elastic", action="store_true", help=_RESILIENCE)
    a("--min_processes", type=int, default=None, help=_RESILIENCE)
    a("--regrow_after_s", type=float, default=None, help=_RESILIENCE)
    a("--supervisor_port", type=int, default=None, help=_RESILIENCE)
    a("--fault_plan", default=None, help=_RESILIENCE)
    a("--compile_cache_dir", default=None, help=_RESILIENCE)
    a("--journal", default=None, help=_RESILIENCE)
    return p


def _refused(args) -> list[str]:
    out = []
    for flag, on in (
            ("--max_restarts (supervisor restarts)", args.max_restarts > 0),
            ("--restart_backoff_s", args.restart_backoff_s is not None),
            ("--elastic (resizing)", args.elastic),
            ("--min_processes", args.min_processes is not None),
            ("--regrow_after_s", args.regrow_after_s is not None),
            ("--supervisor_port (the supervisor endpoint)",
             args.supervisor_port is not None),
            ("--fault_plan (chaos kills)", args.fault_plan is not None),
            ("--compile_cache_dir (the warm-start cache)",
             args.compile_cache_dir is not None),
            ("--journal (the supervisor's run journal)",
             args.journal is not None)):
        if on:
            out.append(f"{flag} joins the port with {_RESILIENCE}")
    if args.devices_per_process != 1:
        out.append("--devices_per_process: the port runs one device per "
                   "process (a stated departure)")
    return out


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
    if refused:
        raise SystemExit("error: " + "; ".join(refused))
    return launch(args.num_processes, train_args, port=args.port,
                  platform=args.platform)


if __name__ == "__main__":
    sys.exit(main())
