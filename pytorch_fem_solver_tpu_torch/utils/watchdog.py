"""Fail-fast watchdog for scripts that touch the card.

Counterpart of ``pytorch_fem_solver_tpu/utils/watchdog.py``, whose stdlib
code is carried over as it is; only ``probe_device`` touches a device, with
one torch op and a host copy on ``config.resolve_device(device)`` (the
card unless ``device`` names another; no card and no ``device`` raises).

``Watchdog`` runs a daemon thread that force-exits the process with a
single structured JSON line on stdout if an armed phase exceeds its
deadline, so a hung device call becomes a recorded failure instead of a
timeout with no output. Usage::

    wd = Watchdog(metric="my_metric")
    wd.arm(240, "warmup (kernel build + first run)")
    ...  # device-touching work
    wd.disarm()

The emitted JSON has the bench schema (``metric``/``value``/``unit``/
``vs_baseline``) with ``value: null`` and an ``error`` field.
``supervise`` re-runs the calling script with retries and backoff while it
dies on the watchdog.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time


class Watchdog:
    def __init__(self, metric: str = "watchdog", extra: dict | None = None):
        self.metric = metric
        self.extra = extra or {}
        self._lock = threading.Lock()
        self._deadline: float | None = None
        self._label = ""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def arm(self, seconds: float, label: str) -> None:
        """(Re)start the countdown: die with an error JSON after *seconds*."""
        with self._lock:
            self._deadline = time.monotonic() + seconds
            self._label = label
            self._seconds = seconds

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def _loop(self) -> None:
        while True:
            time.sleep(1.0)
            with self._lock:
                deadline, label = self._deadline, self._label
            if deadline is not None and time.monotonic() > deadline:
                result = {
                    "metric": self.metric,
                    "value": None,
                    "unit": "s",
                    "vs_baseline": None,
                    "error": (
                        f"watchdog: '{label}' exceeded "
                        f"{self._seconds:.0f}s (device hung?)"
                    ),
                    **self.extra,
                }
                print(json.dumps(result), flush=True)
                print(
                    f"WATCHDOG FIRED: {result['error']}",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(3)


def probe_device(wd: Watchdog, seconds: float = 90.0, device=None) -> float:
    """Fast device-liveness probe: one tiny device op + host copy.

    Arms *wd* for *seconds*; if the device never answers, the watchdog
    emits the structured failure. ``device`` goes through
    ``config.resolve_device`` (the card when None). Returns the probe
    round-trip time.
    """
    import torch

    from ..config import resolve_device

    dev = resolve_device(device)
    wd.arm(seconds, f"device liveness probe ({seconds:.0f}s)")
    t0 = time.perf_counter()
    (torch.zeros((8,), device=dev) + 1.0).cpu()
    dt = time.perf_counter() - t0
    wd.disarm()
    return dt


def supervise(
    metric: str,
    child_flag: str = "BENCH_CHILD",
    env_prefix: str = "BENCH",
) -> int:
    """Retry-with-backoff supervisor for benchmarks whose device may hang.

    Re-runs the calling script as a subprocess (``{child_flag}=1``) and
    retries across a configurable window whenever the child dies on the
    watchdog (rc=3) or a hard per-attempt cap, so a transient outage inside
    the window does not cost the run its result.

    Knobs (prefixed, e.g. ``BENCH_RETRY_WINDOW_S``):

    - ``{P}_RETRY_WINDOW_S`` (default 1800): total wall-clock budget across
      attempts, including backoff sleeps.
    - ``{P}_MAX_ATTEMPTS`` (default 8).
    - ``{P}_ATTEMPT_CAP_S`` (default 2700): hard subprocess timeout per
      attempt — a backstop for hangs the in-child watchdog cannot catch.
    - ``{P}_RETRY_BACKOFF_S`` (default 30): initial sleep between attempts,
      doubling to a 300 s cap (each failed probe already burns its deadline
      waiting, so the backoff stays modest).

    Non-watchdog child failures (rc not in {3, timeout}) are NOT retried —
    an import error or assertion won't heal with time.

    Returns the exit code to pass to ``sys.exit``: 0 with the child's JSON
    line on stdout on success, 3 with the last structured error JSON once
    the window is exhausted.
    """

    def _log(msg: str) -> None:
        print(f"[supervise] {msg}", file=sys.stderr, flush=True)

    def _env(name: str, default: float) -> float:
        return float(os.environ.get(f"{env_prefix}_{name}", str(default)))

    window = _env("RETRY_WINDOW_S", 1800.0)
    max_attempts = int(_env("MAX_ATTEMPTS", 8))
    attempt_cap = _env("ATTEMPT_CAP_S", 2700.0)
    backoff = _env("RETRY_BACKOFF_S", 30.0)

    script = os.path.abspath(sys.argv[0])
    t_start = time.monotonic()
    last_json: str | None = None
    for attempt in range(1, max_attempts + 1):
        env = dict(os.environ, **{child_flag: "1"})
        t0 = time.perf_counter()
        timed_out = False
        try:
            proc = subprocess.run(
                [sys.executable, script, *sys.argv[1:]],
                env=env,
                stdout=subprocess.PIPE,
                timeout=attempt_cap,
            )
            rc, out = proc.returncode, proc.stdout.decode(errors="replace")
        except subprocess.TimeoutExpired as e:
            timed_out, rc = True, 124
            out = (e.stdout or b"").decode(errors="replace")
        wall = time.perf_counter() - t0
        lines = [ln for ln in out.strip().splitlines() if ln.strip()]
        parsed = None
        if lines:
            last_json = lines[-1]
            try:
                parsed = json.loads(last_json)
            except ValueError:
                parsed = None
        _log(
            f"attempt {attempt}: rc={rc} wall={wall:.1f}s "
            f"value={(parsed or {}).get('value')!r}"
            + (" (hard attempt cap)" if timed_out else "")
        )
        if rc == 0 and parsed is not None and parsed.get("value") is not None:
            print(last_json, flush=True)
            return 0
        retryable = rc == 3 or timed_out
        elapsed = time.monotonic() - t_start
        if not retryable:
            _log(f"rc={rc} is not a watchdog signature; not retrying")
            break
        if attempt >= max_attempts or elapsed + backoff >= window:
            _log(
                f"window exhausted ({elapsed:.0f}s of {window:.0f}s, "
                f"{attempt} attempts)"
            )
            break
        _log(f"retrying in {backoff:.0f}s ({window - elapsed:.0f}s left)")
        time.sleep(backoff)
        backoff = min(backoff * 2.0, 300.0)

    if last_json is None:
        last_json = json.dumps(
            {
                "metric": metric,
                "value": None,
                "unit": "s",
                "vs_baseline": None,
                "error": "supervise: no output from any attempt",
            }
        )
    print(last_json, flush=True)
    return 3
