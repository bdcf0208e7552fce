"""The port stands alone: importing any module of `dist_mnist_tpu_torch`
loads neither `jax` nor the reference package, and no port source (nor
`chip_smoke.py` or the card-only tests) imports either — the machine with
the GPU has no JAX."""

from __future__ import annotations

import ast
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dist_mnist_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dist_mnist_tpu")


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the suite's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


def _sources() -> list[Path]:
    # the card-only tests and the port's scripts run on the GPU machine
    # too; the ranks the data-, tensor-, sequence- and model-parallel
    # tests spawn run the helpers
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py",
        ROOT / "tests/torch_ranks.py", ROOT / "tests/torch_dp_cases.py",
        ROOT / "tests/torch_tp_cases.py", ROOT / "tests/torch_seq_cases.py",
        ROOT / "tests/torch_mp_cases.py", ROOT / "tests/torch_native_cases.py",
        ROOT / "tests/torch_multislice_cases.py",
        ROOT / "tests/torch_zoo_cases.py",
        ROOT / "tests/torch_resilience_cases.py",
        ROOT / "tests/torch_overlap_cases.py",
        *sorted((ROOT / "scripts").glob("torch_*.py"))]


@pytest.mark.parametrize("name", ["parallel/moe.py", "parallel/pipeline.py",
                                  "parallel/collective_matmul.py"])
def test_model_parallel_modules_are_checked(name):
    """The model-parallel slice's modules are among the sources the
    import check reads (and `torch_mp_cases.py` beside them)."""
    assert PORT / name in _sources()
    assert ROOT / "tests/torch_mp_cases.py" in _sources()


@pytest.mark.parametrize("name", [
    "utils/native_build.py", "data/native/batcher.py",
    "parallel/ps_demo/bindings.py", "parallel/ps_demo/demo.py"])
def test_native_layer_modules_are_checked(name):
    """The native layer's modules are among the sources the import check
    reads (and the rank cases of its tests beside them)."""
    assert PORT / name in _sources()
    for cases in ("torch_native_cases.py", "torch_multislice_cases.py",
                  "torch_zoo_cases.py"):
        assert ROOT / "tests" / cases in _sources()


@pytest.mark.parametrize("name", [
    "faults/plan.py", "faults/inject.py", "checkpoint/snapshot.py",
    "checkpoint/peer.py", "cluster/membership.py", "cli/launch.py"])
def test_resilience_modules_are_checked(name):
    """The resilience slice's modules are among the sources the import
    check reads (and the rank cases of its tests beside them)."""
    assert PORT / name in _sources()
    assert ROOT / "tests/torch_resilience_cases.py" in _sources()


@pytest.mark.parametrize("name", [
    "compilecache/__init__.py", "compilecache/key_fields.py",
    "compilecache/startup.py", "compilecache/store.py",
    "parallel/overlap.py"])
def test_overlap_and_compile_cache_modules_are_checked(name):
    """The overlap and compile-cache slice's modules are among the
    sources the import check reads (and the rank cases of its tests
    beside them); the two copies of import-pure or stdlib-only
    reference modules are copies, not imports."""
    assert PORT / name in _sources()
    assert ROOT / "tests/torch_overlap_cases.py" in _sources()


@pytest.mark.parametrize("name", [
    "obs/__init__.py", "obs/registry.py", "obs/exporter.py",
    "obs/anomaly.py", "obs/timeline.py", "obs/fleet.py"])
def test_telemetry_modules_are_checked(name):
    """The telemetry slice's modules are among the sources the import
    check reads."""
    assert PORT / name in _sources()


@pytest.mark.parametrize("name", [
    "serve/router.py", "serve/autoscale.py", "serve/loadgen.py",
    "serve/engine.py", "cli/router.py", "cli/serve.py"])
def test_fleet_modules_are_checked(name):
    """The serving fleet's modules are among the sources the import check
    reads; the router and the autoscaler are copies of the reference's
    stdlib-and-numpy modules, not imports of them."""
    assert PORT / name in _sources()


def test_fleet_trace_script_the_bench_loads_is_standard_library_only():
    """`bench --faults --elastic` loads scripts/fleet_trace.py (no part
    of the JAX package) by path: it imports the standard library only."""
    import sys

    path = ROOT / "scripts" / "fleet_trace.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    top = {n.split(".")[0] for n in names}
    assert top and top <= set(sys.stdlib_module_names) | {"__future__"}


@pytest.mark.parametrize("name", ["data/native/loader.cc",
                                  "parallel/ps_demo/ps_server.cc"])
def test_native_sources_are_the_ports_own_copies(name):
    """The port builds its own copy of each C++ source (a byte copy of the
    reference's), never the reference's file, and includes nothing but
    the C++ standard library."""
    ours = PORT / name
    assert ours.read_bytes() == (ROOT / "dist_mnist_tpu" / name).read_bytes()
    includes = [line.split()[1] for line in ours.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes)
    users = [p for p in PORT.rglob("*.py") if name.split("/")[-1]
             in p.read_text()]
    assert users and all("dist_mnist_tpu/" not in p.read_text()
                         for p in users)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dist_mnist_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'dist_mnist_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 20
    assert bad == "[]"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_port_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert bad == [], f"{path.name} imports {bad}"
