"""Async/sync parameter-server DEMO: the protocol the rank path replaced
(port of the reference `parallel/ps_demo`).

The reference's default mode is asynchronous parameter-server data
parallelism, which a lockstep program of ranks does not run. This package
is the one place native code re-creates the PS protocol itself: a C++
parameter server (`ps_server.cc`, a byte copy of the reference's) holding
the flat master weights and Adam slots, with the ConditionalAccumulator
staleness and aggregation state machine and the FIFO token-queue barrier,
driven by Python worker THREADS that compute real gradients with torch.

`python -m dist_mnist_tpu_torch.parallel.ps_demo.demo` trains the
reference MLP both ways and prints the steps/sec and staleness profile.
"""

from dist_mnist_tpu_torch.parallel.ps_demo.bindings import (
    ParameterServer,
    build_library,
)
from dist_mnist_tpu_torch.parallel.ps_demo.demo import run_demo

__all__ = ["ParameterServer", "build_library", "run_demo"]
