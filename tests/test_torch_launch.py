"""The port's multi-process launcher (`cli/launch.py`) on the CPU: real
OS processes of `cli.train`, each a rank of a gloo group
(`--platform=cpu`), as the reference's tests/test_launch.py drives its
own: two ranks train to the same result, a failing child's exit status
propagates and no child outlives the launch, and a two-rank checkpoint
(FSDP: the chief gathers and writes) resumes on both ranks.

The dataset's synthetic twin is written once into the module's data
directory, so the children load it instead of each synthesizing it.
"""

from __future__ import annotations

import contextlib
import io
import re
import tempfile

import pytest

from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cli import train as train_cli


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


@pytest.fixture(autouse=True)
def _no_live_children():
    """No child of the port's launcher outlives a test."""
    yield
    live = [p.pid for p in launch_mod._LIVE_CHILDREN if p.poll() is None]
    assert live == [], f"launch left children running: {live}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    assert train_cli.main(["--download_only", f"--data_dir={d}",
                           "--config=mlp_mnist", "--device=cpu"]) is None
    return d


def _launch(*train_args, n=2) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.launch(n, list(train_args), platform="cpu")
    return rc, buf.getvalue()


def test_two_process_training(data_dir):
    rc, log = _launch("--config=mlp_mnist", f"--data_dir={data_dir}",
                      "--train_steps=6", "--batch_size=32",
                      "--eval_every=0", "--log_every=2")
    assert rc == 0, log
    for p in ("p0", "p1"):
        assert re.search(rf"\[{p}\].*process {p[1]}/2, 1 local / 2 global "
                         r"devices, backend gloo \(cpu platform\)", log), log
    finals = re.findall(r"\[p(\d)\].*done: step=(\d+) test_acc=([0-9.]+)",
                        log)
    assert sorted(f[0] for f in finals) == ["0", "1"], log
    assert all(f[1] == "6" for f in finals), finals
    assert finals[0][2] == finals[1][2], finals
    # one all-reduce of the flat gradient (and the two metrics) a step
    assert re.search(r'collectives per step: \{"all_reduce_bytes": '
                     r'318048\.0, "all_reduce_calls": 1\.0\}', log), log


def test_launch_propagates_child_failure():
    rc, log = _launch("--config=does_not_exist")
    assert rc != 0
    assert "[launcher]" in log or "error" in log


def test_two_process_fsdp_checkpoint_resume(data_dir, tmp_path):
    """Run 1 saves (the chief gathers the FSDP slices and writes); run 2
    logs restored=True on both ranks and continues to the longer step
    count."""
    common = ["--config=mlp_mnist", f"--data_dir={data_dir}",
              f"--checkpoint_dir={tmp_path / 'ckpt'}", "--batch_size=32",
              "--eval_every=0", "--log_every=2", "--sharding=fsdp",
              "--checkpoint_every_steps=2"]
    rc1, log1 = _launch(*common, "--train_steps=4")
    assert rc1 == 0, log1
    assert re.search(r"\[p0\].*restored=False", log1), log1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.name.isdigit()) == ["0", "2", "4"]
    rc2, log2 = _launch(*common, "--train_steps=8")
    assert rc2 == 0, log2
    for p in ("p0", "p1"):
        assert re.search(rf"\[{p}\].*sharding fsdp, restored=True", log2), log2
        assert re.search(rf"\[{p}\].*done: step=8", log2), log2


@pytest.mark.parametrize("argv,what", [
    (["--max_restarts=2"], "item 13"),
    (["--elastic"], "item 13"),
    (["--fault_plan={}"], "item 13"),
    (["--compile_cache_dir=/x"], "item 13"),
    (["--journal=/x"], "item 13"),
    (["--supervisor_port=0"], "item 13"),
    (["--devices_per_process=2"], "one device per process"),
])
def test_refused_launcher_flags_name_their_reason(argv, what):
    with pytest.raises(SystemExit) as info:
        launch_mod.main(argv + ["--", "--config=mlp_mnist"])
    assert what in str(info.value.code)


def test_exit_status_normalization():
    assert launch_mod._normalize_rc(-9) == 137
    assert launch_mod._normalize_rc(3) == 3
    assert "killed by SIGKILL" in launch_mod._describe_exit("p1", -9)
    assert launch_mod._describe_exit("p0", 2) == "p0 exited rc=2"
