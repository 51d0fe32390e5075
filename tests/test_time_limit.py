"""The per-test time limit (tests/time_limit.py) under pytest-xdist.

One nested pytest run, as the tier-1 command runs (``-p xdist -n 2 --dist
loadfile``), of three files.  ``--dist loadfile`` hands out files by their
number of tests, so the worker that runs six quick tests first goes on to
the blocking file: a test that blocks forever in C (a second ``acquire()``
of a held lock) under a 3 s limit, with a test before it and one after
it.  The other worker runs a file whose last test outlives the limit of
the tests before it, and is done before the limit ends.  The nested run
loads the plugin alone (``-p time_limit``): ``tests/conftest.py`` imports
JAX.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

LIMIT = 3
HERE = Path(__file__).resolve().parent

BLOCKING = textwrap.dedent(f"""
    import json, os, threading, time
    import pytest

    def log(name):
        with open(os.environ["TIME_LIMIT_LOG"], "a") as f:
            f.write(json.dumps([name, time.time()]) + "\\n")

    def test_before():
        log("before")

    @pytest.mark.time_limit({LIMIT})
    def test_blocked():
        log("blocked")
        lock = threading.Lock()
        lock.acquire()
        lock.acquire()

    def test_after():
        log("after")
""")

OUTLIVES = textwrap.dedent("""
    import time
    import pytest

    @pytest.mark.time_limit(1)
    @pytest.mark.parametrize("i", range(3))
    def test_within_its_limit(i):
        time.sleep(0.2)

    def test_outlives_the_limit_before_it():
        time.sleep(1.5)
""")

QUICK = textwrap.dedent("""
    import pytest

    @pytest.mark.parametrize("i", range(6))
    def test_quick(i):
        pass
""")


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env.update(PYTHONPATH=str(HERE), TMPDIR=str(tmp_path / "tmp"),
               TIME_LIMIT_LOG=str(tmp_path / "log.jsonl"))
    (tmp_path / "tmp").mkdir()
    return env


def _pytest(tmp_path, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "time_limit",
         "-p", "no:cacheprovider", "-p", "no:randomly", *args],
        cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("nested")
    (tmp_path / "test_blocking.py").write_text(BLOCKING)
    (tmp_path / "test_outlives.py").write_text(OUTLIVES)
    (tmp_path / "test_quick.py").write_text(QUICK)
    t0 = time.monotonic()
    proc = _pytest(tmp_path, "-p", "xdist", "-n", "2", "--dist", "loadfile",
                   "-rA", "--junitxml", str(tmp_path / "junit.xml"),
                   timeout=120)
    seconds = time.monotonic() - t0
    log = [json.loads(line) for line in
           (tmp_path / "log.jsonl").read_text().splitlines()]
    outcomes = {}
    for case in ET.parse(tmp_path / "junit.xml").getroot().iter("testcase"):
        failed = case.find("failure") is not None or \
            case.find("error") is not None
        outcomes.setdefault(case.get("name"), []).append(
            "failed" if failed else "passed")
    return dict(proc=proc, out=proc.stdout + proc.stderr, seconds=seconds,
                log=log, outcomes=outcomes, tmp=tmp_path / "tmp")


def test_run_ends_within_one_limit(run):
    times = {name: t for name, t in run["log"]}
    # the blocked test's start to the next test's start: the limit, the
    # dump and a fresh worker's start-up, not a second limit
    assert times["after"] - times["blocked"] < LIMIT + 20, run["out"]
    assert run["seconds"] < 120, run["out"]
    assert run["proc"].returncode == 1, run["out"]


def test_blocked_test_fails_with_a_stack_dump(run):
    assert set(run["outcomes"]["test_blocked"]) == {"failed"}, run["out"]
    assert f"Timeout (0:00:0{LIMIT})!" in run["out"]
    assert "in test_blocked" in run["out"]
    assert "crashed while running" in run["out"]


def test_blocked_test_is_not_run_again(run):
    assert [name for name, _ in run["log"]].count("blocked") == 1
    assert "ran past its time limit of 3 s on an earlier worker" \
        in run["out"], run["out"]


def test_test_after_the_blocked_one_passes(run):
    assert run["outcomes"]["test_after"] == ["passed"], run["out"]


def test_test_before_the_blocked_one_passes(run):
    assert run["outcomes"]["test_before"] == ["passed"], run["out"]


def test_limit_is_cancelled_when_a_test_ends(run):
    for i in range(3):
        assert run["outcomes"][f"test_within_its_limit[{i}]"] == ["passed"]
    assert run["outcomes"]["test_outlives_the_limit_before_it"] == \
        ["passed"], run["out"]


def test_finished_file_of_the_crashed_worker_is_not_run_again(run):
    for i in range(6):
        assert run["outcomes"][f"test_quick[{i}]"] == ["passed"], run["out"]


def test_record_is_removed_at_the_end_of_the_run(run):
    assert not [p for p in run["tmp"].iterdir()
                if p.name.startswith("pytest-time-limit-")]


def test_faulthandler_timeout_is_refused(tmp_path):
    (tmp_path / "test_one.py").write_text("def test_one():\n    pass\n")
    proc = _pytest(tmp_path, "-o", "faulthandler_timeout=5", timeout=60)
    assert proc.returncode == pytest.ExitCode.USAGE_ERROR, proc.stderr
    assert "replaced by the per-test time limit" in proc.stderr
