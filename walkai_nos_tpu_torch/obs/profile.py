"""A `torch.profiler` capture window, gated on the engine's dispatches.

Port of `walkai_nos_tpu/obs/profile.py` with its surface (`arm`,
`on_dispatch`, `status`, `from_env`): arm the hook, and the engine's next
dispatch enters a `torch.profiler.profile` (CPU activity, and CUDA
activity where a card is present); the `n`-th dispatch from there exits
it and writes its Chrome trace (`chrome://tracing`, Perfetto) into
`logdir`, as `walkai_profile_<pid>_<window>.json`. The window's device
kernels are those launched between the first and the `n`-th call; the
profiler waits for them when it exits.

`counters`, when set, is a callable returning a dict of running counts
(the kernel wrappers' launch counters, in the demo server): it is read
where the profiler starts and where it stops, and `window_launches()`
gives the last completed window's difference, the launches the window's
trace must hold.

A failure to start or stop is recorded in `status()["last_error"]` and
disarms the hook instead of taking the serving loop down: profiling is a
diagnostic, never a liveness risk. The unarmed cost is one attribute
check per dispatch.

Env knobs (read by `ProfileHook.from_env`, i.e. at engine start):
- WALKAI_PROFILE_DIR: capture directory; arming requires it.
- WALKAI_PROFILE_DISPATCHES: window length in dispatches (default 20).
"""

from __future__ import annotations

import os
import threading

__all__ = ["ProfileHook"]


class ProfileHook:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logdir: str | None = None
        self._remaining = 0
        self._active = False
        self._completed = 0  # capture windows finished
        self._last_error: str | None = None
        self._last_trace: str | None = None
        self._prof = None
        self.counters = None
        self._counts_at_start: dict | None = None
        self._window_launches: dict | None = None

    @classmethod
    def from_env(cls, env=os.environ) -> "ProfileHook":
        hook = cls()
        logdir = env.get("WALKAI_PROFILE_DIR")
        if logdir:
            try:
                n = int(env.get("WALKAI_PROFILE_DISPATCHES", "20"))
            except ValueError:
                n = 20
            hook.arm(n, logdir)
        return hook

    def arm(self, dispatches: int, logdir: str) -> None:
        """Schedule a capture of the next `dispatches` dispatches.
        Re-arming while a window is active is rejected (the running
        window finishes first)."""
        if dispatches <= 0:
            raise ValueError(
                f"dispatches must be > 0; got {dispatches}"
            )
        if not logdir:
            raise ValueError("logdir required")
        with self._lock:
            if self._active:
                raise RuntimeError("capture window already active")
            self._logdir = logdir
            self._remaining = int(dispatches)

    def on_dispatch(self) -> None:
        """Engine hook, called once per dispatch. Fast path (unarmed):
        one lock-free attribute check."""
        if self._remaining == 0 and not self._active:
            return
        with self._lock:
            if self._remaining > 0 and not self._active:
                if self._start(self._logdir):
                    self._active = True
                else:
                    self._remaining = 0  # disarm on failure
                    return
            if self._active:
                self._remaining -= 1
                if self._remaining <= 0:
                    self._stop()
                    self._active = False
                    self._completed += 1

    def _start(self, logdir: str) -> bool:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            self._prof = prof
            if self.counters is not None:
                self._counts_at_start = dict(self.counters())
            return True
        except Exception as e:  # noqa: BLE001 — diagnostics must not kill serving
            self._last_error = f"start_trace: {e!r}"
            return False

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        if self.counters is not None and self._counts_at_start is not None:
            start = self._counts_at_start
            self._window_launches = {
                k: v - start.get(k, 0) for k, v in self.counters().items()
            }
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self._logdir, exist_ok=True)
            path = os.path.join(
                self._logdir,
                f"walkai_profile_{os.getpid()}_{self._completed}.json",
            )
            prof.export_chrome_trace(path)
            self._last_trace = path
        except Exception as e:  # noqa: BLE001
            self._last_error = f"stop_trace: {e!r}"

    def window_launches(self) -> dict | None:
        """What `counters` counted between the last completed window's
        profiler start and stop (None without `counters` or before a
        window completed)."""
        with self._lock:
            return None if self._window_launches is None else dict(
                self._window_launches
            )

    def status(self) -> dict:
        """JAX's status keys, plus `last_trace`: the file the last
        completed window wrote (None before one)."""
        with self._lock:
            return {
                "active": self._active,
                "remaining_dispatches": self._remaining,
                "logdir": self._logdir,
                "completed_windows": self._completed,
                "last_error": self._last_error,
                "last_trace": self._last_trace,
            }
