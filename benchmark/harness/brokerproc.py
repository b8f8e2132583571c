"""The parent's handle on the broker child (``broker_child.py``)."""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

from .manifest import ROOT

CHILD = pathlib.Path(__file__).resolve().parent / "broker_child.py"


class BrokerProcess:
    """Starts at once; ``address()`` waits until it listens. Its output goes
    to ``log``; ``close()`` ends it and waits for it. ``args`` (a
    configuration's ``broker_args``) end the broker's command line."""

    def __init__(self, log: pathlib.Path, *, metrics: bool = False, device: str | None = None,
                 fault: str | None = None, args=()):
        argv = [sys.executable, str(CHILD)]
        if fault is not None:
            argv += ["--fault", fault]
        argv += ["--", "-port", "0"]
        if metrics:
            argv.append("-metrics")
        if device is not None:
            argv += ["-device", device]
        argv += list(args)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.log_path = log
        self._log = open(log, "a")
        self.proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self._log, text=True)
        self._port = None
        self._acks = []
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._log.write(line)
            with self._cv:
                found = re.match(r"broker listening on :(\d+)", line)
                if found:
                    self._port = int(found.group(1))
                elif line.startswith("BENCH-ACK "):
                    self._acks.append(line.split()[1])
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def _wait(self, ready, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        with self._cv:
            while not ready():
                left = deadline - time.monotonic()
                if self.proc.poll() is not None or left <= 0:
                    raise RuntimeError(f"broker: no {what} (exit {self.proc.poll()}); "
                                       f"its log:\n{self.tail()}")
                self._cv.wait(min(left, 1.0))

    def address(self, timeout: float = 300.0) -> str:
        self._wait(lambda: self._port is not None, timeout, "listening line")
        return f"127.0.0.1:{self._port}"

    def command(self, cmd: str, timeout: float = 300.0):
        """Send one control line; with a path argument, return the JSON the
        child wrote there."""
        n = len(self._acks)
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        self._wait(lambda: len(self._acks) > n, timeout, f"answer to {cmd.split()[0]}")
        _, _, path = cmd.partition(" ")
        return json.loads(pathlib.Path(path).read_text()) if path else None

    def cpu_seconds(self) -> float:
        """The child's user and system CPU time so far (Linux)."""
        fields = pathlib.Path(f"/proc/{self.proc.pid}/stat").read_text().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")

    def tail(self, n: int = 4000) -> str:
        self._log.flush()
        return self.log_path.read_text(errors="replace")[-n:]

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("exit\n")
                self.proc.stdin.flush()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._reader.join(timeout=10)
        self._log.close()
