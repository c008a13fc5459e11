"""Serving worker processes (port of sskd_tpu/serve/supervisor.py).

``supervise`` starts ``n_workers`` fresh interpreters (never a fork: a
forked process would share the parent's CUDA state), each binding the same
port with SO_REUSEPORT so that the kernel spreads the connections. SIGTERM
or SIGINT to the supervisor goes on to the workers, which drain; a worker
that dies otherwise is restarted with a growing delay, up to
``max_restarts`` times. The CLI forks only on the CPU platform: one process
owns the card.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.supervisor")

WORKER_ENV = "SSKD_SERVE_WORKER"  # set in the workers, so that they serve and do not spawn


def supervise(worker_argv: list[str], n_workers: int, max_restarts: int = 5,
              restart_delay_s: float = 1.0) -> int:
    """Run ``n_workers`` copies of ``worker_argv`` until they exit: 0 when
    every worker ended cleanly after a shutdown signal, 1 when one used up
    its restarts or ended otherwise."""
    env = dict(os.environ)
    env[WORKER_ENV] = "1"
    env["SEMANTIC_KD_SERVICE__WORKERS"] = "1"  # a worker never supervises

    procs: dict[int, subprocess.Popen] = {}
    restarts = [0] * n_workers
    shutting_down = False

    def _spawn(slot: int) -> None:
        procs[slot] = subprocess.Popen(worker_argv, env=env)
        logger.info(f"worker {slot}: pid {procs[slot].pid} started")

    def _term_live() -> None:
        for p in list(procs.values()):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    def _forward(signum, _frame) -> None:
        nonlocal shutting_down
        shutting_down = True
        logger.info(f"{signal.Signals(signum).name} received: stopping workers")
        _term_live()

    old_term = signal.signal(signal.SIGTERM, _forward)
    old_int = signal.signal(signal.SIGINT, _forward)
    failed = False
    done: set[int] = set()
    try:
        for slot in range(n_workers):
            _spawn(slot)
        while len(done) < n_workers:
            for slot in range(n_workers):
                if slot in done:
                    continue
                code = procs[slot].poll()
                if code is None:
                    continue
                if code == 0 or shutting_down:
                    done.add(slot)
                elif restarts[slot] < max_restarts:
                    restarts[slot] += 1
                    logger.warning(f"worker {slot} (pid {procs[slot].pid}) exited {code}; "
                                   f"restart {restarts[slot]}/{max_restarts}")
                    time.sleep(restart_delay_s * restarts[slot])
                    if shutting_down:  # the signal came during the delay
                        done.add(slot)
                        continue
                    _spawn(slot)
                else:
                    logger.error(f"worker {slot} exhausted {max_restarts} restarts")
                    failed = True
                    done.add(slot)
            if shutting_down:
                # a worker started just before the signal missed it: signal
                # the live ones on every sweep (a draining server ignores it)
                _term_live()
            time.sleep(0.1)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    codes = {s: p.returncode for s, p in procs.items()}
    logger.info(f"supervisor exiting; worker codes {codes}")

    def _clean(code: int) -> bool:
        # at shutdown, a worker killed by the forwarded SIGTERM before it
        # installed its handlers ended cleanly too
        return code == 0 or (shutting_down and code == -signal.SIGTERM)

    return 1 if failed or not all(_clean(c) for c in codes.values()) else 0


def is_worker() -> bool:
    """True inside a supervised worker process."""
    return os.environ.get(WORKER_ENV, "0") == "1"


def reexec_argv() -> list[str]:
    """The argv that starts this invocation again as one worker."""
    return [sys.executable, "-m", "sskd_tpu_torch.cli.main", *sys.argv[1:]]
