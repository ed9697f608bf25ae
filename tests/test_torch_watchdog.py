"""PyTorch port, ``utils/watchdog.py``: the twins of the JAX package's
``tests/test_watchdog.py`` and ``tests/test_watchdog_supervise.py``
(subprocesses), plus ``probe_device``.

An armed phase that overruns exits rc=3 with one parseable JSON line on
stdout carrying the metric, ``value: null``, the label and the extra keys;
a disarmed watchdog does nothing. ``supervise`` retries watchdog failures
(rc=3) until the child succeeds, does not retry another failure, and after
an exhausted window prints the last structured error. ``probe_device``
runs its op on the device it is given and disarms; with no card and no
device it raises and does not fall back to the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from pytorch_fem_solver_tpu_torch.utils.watchdog import Watchdog, probe_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    p for p in (REPO, os.environ.get("PYTHONPATH")) if p))

SNIPPET_FIRE = """
import time
from pytorch_fem_solver_tpu_torch.utils.watchdog import Watchdog
wd = Watchdog(metric="test_metric", extra={"phase": "unit"})
wd.arm(1.0, "simulated hang")
time.sleep(30)
print("UNREACHABLE")
"""

SNIPPET_DISARM = """
import time
from pytorch_fem_solver_tpu_torch.utils.watchdog import Watchdog
wd = Watchdog(metric="test_metric")
wd.arm(5.0, "phase")
wd.disarm()
time.sleep(1.5)
print("survived")
"""


def _run(snippet):
    return subprocess.run([sys.executable, "-c", snippet], capture_output=True, text=True,
                          timeout=60, env=ENV)


def test_watchdog_fires_with_structured_json():
    proc = _run(SNIPPET_FIRE)
    assert proc.returncode == 3
    assert "UNREACHABLE" not in proc.stdout
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["metric"] == "test_metric"
    assert result["value"] is None and result["unit"] == "s" and result["vs_baseline"] is None
    assert "simulated hang" in result["error"]
    assert result["phase"] == "unit"
    assert "WATCHDOG FIRED" in proc.stderr


def test_watchdog_disarm_is_inert():
    proc = _run(SNIPPET_DISARM)
    assert proc.returncode == 0
    assert "survived" in proc.stdout


CHILD_TEMPLATE = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    if os.environ.get("BENCH_CHILD") == "1":
        cnt_file = sys.argv[1]
        n = int(open(cnt_file).read())
        open(cnt_file, "w").write(str(n + 1))
        if n < {fail_times}:
            print(json.dumps({{
                "metric": "t", "value": None, "unit": "s",
                "vs_baseline": None, "error": "simulated outage"}}))
            sys.exit({fail_rc})
        print(json.dumps({{
            "metric": "t", "value": 1.5, "unit": "s", "vs_baseline": 2.0}}))
        sys.exit(0)
    from pytorch_fem_solver_tpu_torch.utils.watchdog import supervise
    sys.exit(supervise("t"))
    """
)


def _supervise(tmp_path, fail_times, fail_rc, max_attempts=8):
    script = tmp_path / "fake_bench.py"
    counter = tmp_path / "count.txt"
    counter.write_text("0")
    script.write_text(CHILD_TEMPLATE.format(repo=REPO, fail_times=fail_times, fail_rc=fail_rc))
    env = dict(ENV, BENCH_RETRY_BACKOFF_S="0.05", BENCH_RETRY_WINDOW_S="60",
               BENCH_MAX_ATTEMPTS=str(max_attempts))
    proc = subprocess.run([sys.executable, str(script), str(counter)], env=env,
                          capture_output=True, timeout=120)
    out = proc.stdout.decode().strip().splitlines()
    return proc.returncode, json.loads(out[-1]) if out else None, int(counter.read_text())


def test_retries_watchdog_failures_until_success(tmp_path):
    rc, parsed, attempts = _supervise(tmp_path, fail_times=2, fail_rc=3)
    assert rc == 0 and parsed["value"] == 1.5
    assert attempts == 3  # 2 failures + 1 success


def test_does_not_retry_non_watchdog_failure(tmp_path):
    rc, parsed, attempts = _supervise(tmp_path, fail_times=1, fail_rc=1)
    assert rc == 3 and parsed["value"] is None
    assert attempts == 1


def test_exhausted_window_emits_last_error_json(tmp_path):
    rc, parsed, attempts = _supervise(tmp_path, fail_times=99, fail_rc=3, max_attempts=3)
    assert rc == 3 and parsed["value"] is None and "error" in parsed
    assert attempts == 3


def test_probe_device_on_the_cpu():
    wd = Watchdog(metric="probe")
    dt = probe_device(wd, seconds=30.0, device="cpu")
    assert dt >= 0.0
    assert wd._deadline is None  # disarmed after the probe


def test_probe_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = Watchdog(metric="probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_device(wd, seconds=30.0)
    assert wd._deadline is None  # raised before arming
