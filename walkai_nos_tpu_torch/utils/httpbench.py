"""Helpers for driving the port's demo server over HTTP.

The port's own copy of `walkai_nos_tpu/utils/httpbench.py`: a free
port, the JSON client calls, the keep-alive `/infer` client, and the
child-process lifecycle (`spawn_server` / `kill_server`) of
`python -m walkai_nos_tpu_torch.app.main`. `chip_smoke.py` and the
tests drive the server through these, so the boot, teardown and client
paths cannot drift apart.

Unlike the JAX copy, `spawn_server` writes the child's output to a file
the caller names (never an unread pipe, which blocks the child once it
fills), starts the child in a new session, and `kill_server` waits with
a bound before it kills.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

__all__ = [
    "InferClient",
    "free_port",
    "get_json",
    "kill_server",
    "post_infer",
    "post_json",
    "spawn_server",
]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SERVER_MODULE = "walkai_nos_tpu_torch.app.main"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def post_json(url: str, payload: dict, timeout: float = 150.0) -> dict:
    """POST a JSON payload, return the decoded JSON response."""
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def post_infer(base: str, batch: int, timeout: float = 150.0) -> dict:
    return post_json(f"{base}/infer", {"batch": batch}, timeout=timeout)


class InferClient:
    """A persistent-connection `/infer` client for one stream thread
    (one keep-alive connection per stream, as a real async client drives
    a server). Not thread-safe: one instance per thread."""

    def __init__(self, base: str, timeout: float = 150.0) -> None:
        import http.client
        from urllib.parse import urlparse

        self._netloc = urlparse(base).netloc
        self._timeout = timeout
        self._http = http.client
        self._conn = None

    def post_infer(self, batch: int) -> dict:
        body = json.dumps({"batch": batch})
        headers = {"Content-Type": "application/json"}
        if self._conn is None:
            self._conn = self._http.HTTPConnection(
                self._netloc, timeout=self._timeout
            )
        try:
            self._conn.request("POST", "/infer", body, headers)
            resp = self._conn.getresponse()
            data = resp.read()
        except Exception:
            # Dead keep-alive: drop it; the caller retries on a fresh one.
            self.close()
            raise
        if resp.status != 200:
            # Error responses close the server side; reconnect next time.
            self.close()
            raise RuntimeError(f"/infer -> {resp.status}")
        return json.loads(data)

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None


def spawn_server(
    env_overrides: dict[str, str],
    startup_timeout_s: float,
    log_path: str,
    poll_s: float = 0.5,
    argv: list[str] | None = None,
) -> tuple[subprocess.Popen, str]:
    """Start a demo server on a free port and wait for /healthz.

    The child runs `argv` (default `python -m
    walkai_nos_tpu_torch.app.main`) from the repository root in a session
    of its own, with `PORT` set and its stdout and stderr appended to
    `log_path`. Healthy means /healthz answers and the child itself holds
    the port's listening socket. Returns (process, base_url); raises
    RuntimeError (the child killed and reaped, the log's tail in the
    message) if it exits or never becomes healthy."""
    port = free_port()
    env = dict(os.environ)
    env.update(env_overrides)
    env["PORT"] = str(port)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            argv or [sys.executable, "-m", SERVER_MODULE],
            cwd=REPO,
            env=env,
            stdin=subprocess.DEVNULL,
            stdout=log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + startup_timeout_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(
                f"demo server exited {proc.returncode} during startup:\n"
                f"{_tail(log_path)}"
            )
        try:
            get_json(f"{base}/healthz", timeout=2.0)
            # Another process may have bound the port between free_port()
            # and the child's bind: only the child's own socket counts.
            if _listens(proc.pid, port):
                return proc, base
        except Exception:
            pass
        if time.monotonic() > deadline:
            kill_server(proc)
            raise RuntimeError(
                f"demo server never became healthy:\n{_tail(log_path)}"
            )
        time.sleep(poll_s)


def _listens(pid: int, port: int) -> bool:
    """Whether process `pid` holds the listening TCP socket on `port`
    (read from Linux's /proc; True where there is no /proc/net/tcp to
    ask)."""
    if not os.path.exists("/proc/net/tcp"):
        return True
    sockets = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            # cols[1] is local "ADDR:PORT" in hex, cols[3] the state
            # (0A = LISTEN), cols[9] the socket's inode.
            if cols[3] == "0A" and int(cols[1].rsplit(":", 1)[1], 16) == port:
                sockets.add(f"socket:[{cols[9]}]")
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}") in sockets:
                return True
        except OSError:
            continue
    return False


def kill_server(proc: subprocess.Popen, timeout_s: float = 10.0) -> None:
    """Terminate, wait at most `timeout_s`, then kill and reap."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=timeout_s)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""
