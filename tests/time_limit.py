"""A time limit for each test, for pytest without pytest-timeout.

A watchdog (``faulthandler.dump_traceback_later`` with ``exit=True``) is
armed for a test's setup, call and teardown; module fixtures are built in
the setup of a module's first test and torn down with its last.  At the
limit it dumps every thread's stack to stderr and ends the process, even
when the main thread is blocked inside C code.  Under pytest-xdist the
controller then reports the test as failed and starts a fresh worker for
the tests that are left.

xdist hands the unfinished test of a crashed worker to the fresh worker,
where it would block again.  So a worker writes each test's node id into a
record of the run (a directory in the temporary directory, named by
xdist's ``testrunuid``) before the test starts, and removes it when the
test ends.  A test already in the record fails at once in setup and is not
run again.

xdist 3.8's ``--dist loadfile`` also puts the crashed worker's finished
files back in the queue; the fresh worker is given one, runs nothing, and
is never given more, so the run waits for its end.  The scheduler here
drops finished files first.

A test's limit is ``DEFAULT_SECONDS`` unless it is marked
``@pytest.mark.time_limit(seconds)``; the tests that run the JAX
package's Pallas kernels in TPU-interpret mode, where hangs were seen, are
marked with about three times their longest time under the tier-1
command.  ``tests/conftest.py`` loads this
module; a run without that conftest loads it with ``-p time_limit`` and
``tests/`` on ``PYTHONPATH``.
"""

import faulthandler
import hashlib
import json
import os
import shutil
import tempfile
import time
import uuid

import pytest

# Only catches a hang: well above the slowest test's time under the
# 6-worker tier-1 command.
DEFAULT_SECONDS = 600.0

_STDERR_FD = pytest.StashKey[int]()
_EARLIER = pytest.StashKey[str]()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "time_limit(seconds): the test's setup, call and "
        f"teardown end its process after this long (default "
        f"{DEFAULT_SECONDS:g} s; tests/time_limit.py)")
    if float(_ini(config, "faulthandler_timeout") or 0):
        raise pytest.UsageError(
            "faulthandler_timeout is replaced by the per-test time limit "
            "(tests/time_limit.py), which dumps every thread's stack at "
            "the limit; set a shorter limit with @pytest.mark.time_limit")
    config.stash[_STDERR_FD] = os.dup(2)   # stderr, not pytest's capture
    # The controller picks the run's id, so that it can remove the record.
    if (not hasattr(config, "workerinput")
            and getattr(config.option, "testrunuid", False) is None):
        config.option.testrunuid = uuid.uuid4().hex


def pytest_unconfigure(config):
    if _STDERR_FD in config.stash:
        os.close(config.stash[_STDERR_FD])
        del config.stash[_STDERR_FD]
    if not hasattr(config, "workerinput"):
        uid = getattr(config.option, "testrunuid", None)
        if uid:
            shutil.rmtree(_record_dir(uid), ignore_errors=True)


def _ini(config, name):
    try:
        return config.getini(name)
    except ValueError:          # -p no:faulthandler
        return None


def _record_dir(uid):
    return os.path.join(tempfile.gettempdir(), f"pytest-time-limit-{uid}")


def _record_file(item):
    """The test's entry in the run's record; None outside xdist workers,
    where the watchdog ends the whole run and nothing runs the test again."""
    workerinput = getattr(item.config, "workerinput", None)
    if workerinput is None:
        return None
    name = hashlib.sha1(item.nodeid.encode()).hexdigest()
    return os.path.join(_record_dir(workerinput["testrunuid"]), name)


def _limit(item):
    marker = item.get_closest_marker("time_limit")
    return float(marker.args[0]) if marker else DEFAULT_SECONDS


def _earlier(entry):
    with open(entry) as f:
        was = json.load(f)
    if time.time() - was["start"] >= was["limit"]:
        return (f"ran past its time limit of {was['limit']:g} s on an "
                "earlier worker, which dumped its threads' stacks to stderr "
                "and ended; not run again")
    return ("its earlier worker ended before the test did, within its "
            "time limit; not run again")


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def remove_node(self, node):
            workload = self.assigned_work[node]
            for scope in [s for s, unit in workload.items()
                          if all(unit.values())]:
                del workload[scope]
            return super().remove_node(node)

    return Scheduling(config, log)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    entry = _record_file(item)
    if entry is not None and os.path.exists(entry):
        item.stash[_EARLIER] = _earlier(entry)
        return (yield)
    limit = _limit(item)
    if entry is not None:
        os.makedirs(os.path.dirname(entry), exist_ok=True)
        with open(entry, "w") as f:
            json.dump({"nodeid": item.nodeid, "limit": limit,
                       "start": time.time()}, f)
    faulthandler.dump_traceback_later(
        limit, exit=True, file=item.config.stash[_STDERR_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if entry is not None:
            os.remove(entry)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    reason = item.stash.get(_EARLIER, None)
    if reason is not None:
        pytest.fail(reason, pytrace=False)
