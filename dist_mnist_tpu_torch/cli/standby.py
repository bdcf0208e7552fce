"""A stand-by rank process for the supervisor (`cli/launch.py`).

    python -m dist_mnist_tpu_torch.cli.standby dist_mnist_tpu_torch.cli.train

Imports the rank module (torch with it), then blocks on one JSON line
on stdin, ``{"argv": [...], "env": {...}, "sent": <wall time>}``: it
applies the rank's environment, moves the module's cold-start clock
(`_MODULE_T0`) to the hand-off when the import ended before it, keeps
the import paid before the hand-off as `_STANDBY_IMPORT_S` (the startup
record's ``standby_import_ms``), and runs ``module.main(argv)`` as
``python -m <module> <argv>`` would. End of input without a line exits 0
at once (a stand-by the supervisor no longer needs). The exit status is
main's: 0, or a `SystemExit`'s code.

The launcher starts every rank of a module launch this way, handing a
rank its line at once; a supervised run also starts the next
generation's ranks while the current one trains, so a re-formed
generation starts at `main` instead of importing torch (seconds, more
on a loaded host) inside the recovery window.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    module = importlib.import_module(argv[0])
    imported = time.monotonic()
    line = sys.stdin.readline()
    if not line.strip():
        return 0
    msg = json.loads(line)
    os.environ.update(msg["env"])
    if hasattr(module, "_MODULE_T0"):
        # the hand-off on this clock (one host: the wall clocks agree)
        sent = time.monotonic() - max(0.0, time.time() - msg["sent"])
        start = module._MODULE_T0
        module._STANDBY_IMPORT_S = max(0.0, min(sent, imported) - start)
        module._MODULE_T0 = max(start, sent)
    sys.argv = [argv[0], *msg["argv"]]
    module.main(list(msg["argv"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
