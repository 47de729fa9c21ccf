"""Deterministic capture plane: a black-box request recorder whose
captures replay token-identically offline.

Port of `walkai_nos_tpu/obs/capture.py`. The serving engine's defining
invariant is that every request's output is a pure function of
(weights, prompt, sampling knobs, seed), independent of batch
composition, chunking, spec rounds, loop folding and quantization-sim.
`CaptureLog` turns that invariant into an artifact: a bounded, rotating
on-disk log whose header pins the engine's config fingerprint (every
determinism-relevant knob plus a weights digest) and whose per-request
records pin the inputs the invariant quantifies over, so a capture can
be re-executed by `sim/replay.py` and verified token for token.

File format (the JAX package's, line for line: a capture written by
either package loads in the other), one JSON object per line, every
file self-contained:

    {"kind": "header", "version": 1, "fingerprint": {...},
     "created_unix_s": ...}
    {"kind": "submit", "rid": ..., "trace_id": ..., "prompt": [...],
     "max_new_tokens": ..., "eos_id": ..., "temperature": ...,
     "top_k": ..., "top_p": ..., "seed": <EFFECTIVE seed>,
     "arrival_s": <monotonic offset from capture origin>}
    {"kind": "done", "rid": ..., "trace_id": ..., "tokens": [...],
     "n_tokens": ..., "digest": "crc32:...", "ttft_s": ...,
     "wall_s": ..., "truncated": ..., "reason": ...}

`seed` is the EFFECTIVE per-request seed (the engine defaults an unset
seed to the request id), so a replay under fresh request ids reproduces
the original sampling streams. `tokens` rides the done record beside
its digest: the digest is the cheap zero-divergence check, the token
list is what first-divergence triage needs.

Rotation keeps the recorder bounded: when the current file passes
`max_bytes` it closes and a fresh file (with its own header) opens;
files beyond `max_files` are pruned oldest first, their records counted
as dropped. Drops and write failures are counted (`stats()`, and the
engine's `cb_capture_*` series in its `obs/serving.ServingObs`).

Writer: `ContinuousBatcher(capture=...)` records at its submit and
commit seams. Readers: `sim/replay.py` (`load_capture` /
`replay_capture`) and `cmd/replay.py`.

`tree_crc32` digests a tree of numpy arrays or torch tensors (on any
device) as the JAX package's digests its jax arrays: a bf16 leaf, which
numpy cannot hold, is written as the dtype name `bfloat16` and its raw
2-byte words, which is what numpy's `bfloat16` extension type gives.
Stdlib, numpy and torch only.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
import zlib
from collections.abc import Mapping

import numpy as np
import torch

__all__ = [
    "CaptureLog",
    "fingerprint_id",
    "rotate_action_from_body",
    "token_digest",
    "tree_crc32",
]


def rotate_action_from_body(raw: bytes) -> str:
    """Validate a /debug/capture POST body: the one action contract a
    serving binary's capture endpoint applies. Raises ValueError
    (which JSONDecodeError subclasses) on anything but a JSON object
    requesting a supported action; the caller maps that to a 400."""
    body = json.loads(raw or b"{}")
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    action = body.get("action", "rotate")
    if action != "rotate":
        raise ValueError(
            f"unknown action {action!r} (supported: rotate)"
        )
    return action

_FILE_RE = re.compile(r"^capture-(\d+)\.jsonl$")


def token_digest(tokens) -> str:
    """Digest of one request's output token stream: CRC-32 over the
    int32 little-endian token bytes — byte-identical streams and only
    byte-identical streams agree, and the check costs microseconds
    per request at capture AND at replay verification."""
    arr = np.asarray(list(tokens), dtype="<i4")
    return f"crc32:{zlib.crc32(arr.tobytes()):08x}"


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs of a tree of mappings and sequences, as
    `jax.tree_util.tree_leaves_with_path` walks it: a mapping's keys in
    sorted order, a list's or tuple's items by index."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves_with_path(item, path + (i,))
    elif tree is not None:
        yield path, tree


def _leaf_bytes(leaf) -> tuple[str, bytes]:
    """(`dtype:shape` header, raw bytes) of one leaf, as numpy writes
    them. A torch tensor comes to the host first; a bf16 one as its
    2-byte words under the name numpy's `bfloat16` type prints."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            words = t.contiguous().view(torch.int16).cpu().numpy()
            return f"bfloat16:{tuple(t.shape)}", words.tobytes()
        leaf = t.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(leaf))
    return f"{a.dtype}:{a.shape}", a.tobytes()


def tree_crc32(tree) -> int:
    """Content digest of a parameter tree: CRC-32 accumulated over
    every leaf's path (`jax.tree_util.keystr`'s form,
    `['block0']['attn']['qkv']['kernel']`), dtype, shape and raw bytes,
    leaves visited in path-sorted order, so the digest is independent of
    dict insertion order and equals the JAX package's on the same
    values. Device tensors are read back to the host."""
    crc = 0
    leaves = sorted(
        ((_keystr(p), leaf) for p, leaf in _leaves_with_path(tree)),
        key=lambda kv: kv[0],
    )
    for path, leaf in leaves:
        head, raw = _leaf_bytes(leaf)
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(head.encode(), crc)
        crc = zlib.crc32(raw, crc)
    return crc


def fingerprint_id(fingerprint: dict) -> str:
    """Short stable id of a config fingerprint: sha1 over the
    canonical (sorted-keys) JSON of every field except `id` itself.
    12 hex chars — enough to correlate a logged completion with the
    capture that can replay it, short enough to ride every record."""
    body = {k: v for k, v in fingerprint.items() if k != "id"}
    blob = json.dumps(body, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


class CaptureLog:
    """Bounded, rotating on-disk request recorder (ndjson ring).

    Thread-safe: the engine's driver thread writes records while a
    server handler thread may rotate or read status. Telemetry
    discipline: a failed write is counted (`write_error` drop) and
    swallowed — the recorder must never take serving down.
    """

    def __init__(
        self,
        directory: str,
        *,
        max_bytes: int = 16 << 20,
        max_files: int = 4,
    ):
        if max_bytes <= 0 or max_files <= 0:
            raise ValueError(
                f"max_bytes and max_files must be > 0; got "
                f"{max_bytes}, {max_files}"
            )
        self.dir = str(directory)
        self.max_bytes = max_bytes
        self.max_files = max_files
        self._lock = threading.Lock()
        self._fp = None  # current file object
        self._file = None  # current file name
        self._file_bytes = 0
        # name -> record count, for drop accounting when pruned.
        self._file_records: dict[str, int] = {}
        self._header_line: str | None = None
        self.fingerprint: dict | None = None
        self._origin: float | None = None
        self._obs = None  # ServingObs-shaped bundle (optional)
        self._records = {"submit": 0, "done": 0}
        self._bytes = 0
        self._dropped = {"rotated": 0, "write_error": 0}
        # Continue the sequence past whatever an earlier process left
        # in the directory, so two runs never collide on a file name.
        self._seq = self._max_existing_seq() + 1

    @classmethod
    def coerce(cls, value) -> "CaptureLog | None":
        """The ONE capture-argument contract every constructor
        (`ContinuousBatcher`) applies: a directory path
        builds a log, a CaptureLog or None passes through, anything
        else is a loud ValueError — a silently-disabled incident
        recorder is discovered at the incident."""
        if isinstance(value, (str, os.PathLike)):
            return cls(os.fspath(value))
        if value is None or isinstance(value, cls):
            return value
        raise ValueError(
            "capture must be a CaptureLog, a directory path, or "
            f"None; got {type(value).__name__}"
        )

    @classmethod
    def from_env(cls, env=None) -> "CaptureLog | None":
        """The ONE env-arming rule every serving binary shares:
        WALKAI_CAPTURE_DIR arms the recorder,
        WALKAI_CAPTURE_MAX_BYTES / WALKAI_CAPTURE_MAX_FILES bound the
        ring. None when unset — two copies of this mapping already
        drifted once (one binary silently ignoring the bounds
        knobs), so neither binary may reimplement it."""
        env = os.environ if env is None else env
        directory = env.get("WALKAI_CAPTURE_DIR")
        if not directory:
            return None
        return cls(
            directory,
            max_bytes=int(
                env.get("WALKAI_CAPTURE_MAX_BYTES", str(16 << 20))
            ),
            max_files=int(env.get("WALKAI_CAPTURE_MAX_FILES", "4")),
        )

    # -- lifecycle -----------------------------------------------------

    def attach(self, fingerprint: dict, *, obs=None) -> None:
        """Arm the log: pin the writer's config fingerprint (written
        as the header of every file) and start the arrival clock.
        `obs` is the engine's `obs/serving.ServingObs` — when given, its
        `capture_*` counters mirror the internal tallies."""
        self.fingerprint = fingerprint
        self._obs = obs
        self._origin = time.monotonic()
        self._header_line = json.dumps({
            "kind": "header",
            "version": 1,
            "fingerprint": fingerprint,
            "created_unix_s": time.time(),
        }, default=str)
        with self._lock:
            self._open_locked()

    @property
    def armed(self) -> bool:
        return self._origin is not None

    def arrival_offset(self, t_monotonic: float) -> float:
        """Monotonic seconds since the capture armed — the submit
        record's arrival timestamp (what original-timing replay
        re-paces against)."""
        if self._origin is None:
            return 0.0
        return max(0.0, t_monotonic - self._origin)

    # -- record writers ------------------------------------------------

    def record_submit(self, **fields) -> None:
        self._write("submit", fields)

    def record_done(self, **fields) -> None:
        self._write("done", fields)

    def _write(self, kind: str, fields: dict) -> None:
        line = json.dumps({"kind": kind, **fields}, default=str)
        with self._lock:
            if self._fp is None:
                self._open_locked()
            if self._fp is None:
                # Open itself failed (dir unwritable, disk full):
                # count the loss and keep serving — the recorder
                # must never take the engine's driver thread down.
                self._dropped["write_error"] += 1
                if self._obs is not None:
                    self._obs.capture_dropped.inc(
                        labels={"reason": "write_error"}
                    )
                return
            try:
                self._fp.write(line + "\n")
                self._fp.flush()
            except (OSError, ValueError):
                self._dropped["write_error"] += 1
                if self._obs is not None:
                    self._obs.capture_dropped.inc(
                        labels={"reason": "write_error"}
                    )
                return
            n = len(line) + 1
            self._file_bytes += n
            self._bytes += n
            self._file_records[self._file] = (
                self._file_records.get(self._file, 0) + 1
            )
            self._records[kind] = self._records.get(kind, 0) + 1
            if self._obs is not None:
                self._obs.capture_records.inc(labels={"kind": kind})
                self._obs.capture_bytes.inc(n)
            if self._file_bytes >= self.max_bytes:
                self._rotate_locked()

    # -- rotation ------------------------------------------------------

    def rotate(self) -> None:
        """Close the current file and start a fresh one (each file is
        self-contained behind its own header) — the /debug/capture
        rotate action, e.g. to freeze an incident's tail before
        downloading it."""
        with self._lock:
            self._rotate_locked()

    def _open_locked(self) -> None:
        # Exclusive create ("x") with a bump-and-retry: two processes
        # sharing one capture dir (a rolling restart's overlap) must
        # never truncate each other's live file — "w" would lose the
        # other process's records with no drop accounting.
        name = path = None
        try:
            os.makedirs(self.dir, exist_ok=True)
            for _ in range(10_000):
                name = f"capture-{self._seq:06d}.jsonl"
                self._seq += 1
                path = os.path.join(self.dir, name)
                try:
                    self._fp = open(path, "x")
                    break
                except FileExistsError:
                    continue
            else:
                raise OSError("no free capture sequence number")
            if self._header_line is not None:
                self._fp.write(self._header_line + "\n")
                self._fp.flush()
                self._file_bytes = len(self._header_line) + 1
                self._bytes += self._file_bytes
                if self._obs is not None:
                    self._obs.capture_bytes.inc(self._file_bytes)
            else:
                self._file_bytes = 0
        except OSError:
            # A failed HEADER write (ENOSPC after a successful
            # metadata-only open) must not abandon the fd or the
            # stray empty file: every later record re-enters here,
            # and leaked fds would eventually EMFILE the server —
            # the recorder taking serving down, its one forbidden
            # failure mode.
            if self._fp is not None:
                try:
                    self._fp.close()
                except OSError:
                    pass
                if path is not None:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            self._fp = None
            self._file = None
            return
        self._file = name
        self._file_records.setdefault(name, 0)

    def _rotate_locked(self) -> None:
        if self._fp is not None:
            try:
                self._fp.close()
            except OSError:
                pass
            self._fp = None
            self._file = None
        self._open_locked()
        self._prune_locked()

    def _prune_locked(self) -> None:
        # The ring bound applies to files THIS instance wrote: a
        # shared dir's older files may belong to a still-LIVE process
        # (rolling-restart overlap — the same scenario the exclusive
        # create guards), and unlinking its live file would lose its
        # records with zero drop accounting on either side. Foreign
        # files (dead runs' leftovers, replayable via --run) expire
        # only once the dir exceeds TWICE the ring — disk stays
        # bounded, an overlapping writer's ring is never touched
        # (it prunes itself to max_files).
        files = self._list_files()
        own = [n for n in files if n in self._file_records]
        while len(own) > self.max_files:
            victim = own.pop(0)
            lost = self._file_records.pop(victim, 0)
            # The header line is format, not payload — only request
            # records count as dropped capture data.
            self._count_drop_locked(lost)
            try:
                os.remove(os.path.join(self.dir, victim))
            except OSError:
                break
            files.remove(victim)
        foreign = [n for n in files if n not in self._file_records]
        while foreign and len(files) > 2 * self.max_files:
            victim = foreign.pop(0)
            self._count_drop_locked(self._count_records_in(victim))
            try:
                os.remove(os.path.join(self.dir, victim))
            except OSError:
                break
            files.remove(victim)

    def _count_drop_locked(self, lost: int) -> None:
        self._dropped["rotated"] += lost
        if self._obs is not None and lost:
            self._obs.capture_dropped.inc(
                lost, labels={"reason": "rotated"}
            )

    def _count_records_in(self, name: str) -> int:
        """Request records in a FOREIGN file about to expire (we
        never wrote it, so its count isn't in our books) — a dropped
        tally must never read as 'nothing lost' when a dead run's
        records go."""
        try:
            with open(os.path.join(self.dir, name)) as f:
                return sum(
                    1 for line in f
                    if line.strip() and '"kind": "header"' not in line
                )
        except OSError:
            return 0

    def _list_files(self) -> list[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n for n in names if _FILE_RE.match(n))

    def _max_existing_seq(self) -> int:
        best = 0
        for name in self._list_files():
            best = max(best, int(_FILE_RE.match(name).group(1)))
        return best

    # -- read surface --------------------------------------------------

    def files(self) -> list[str]:
        """Current capture file paths, oldest first."""
        with self._lock:
            return [
                os.path.join(self.dir, n) for n in self._list_files()
            ]

    def read_text(self) -> str:
        """Every retained file concatenated, oldest first — the
        /debug/capture download body (each file carries its own
        header, so the concatenation parses as one capture)."""
        parts = []
        for path in self.files():
            try:
                with open(path) as f:
                    parts.append(f.read())
            except OSError:
                continue
        return "".join(parts)

    def stats(self) -> dict:
        """The /debug/capture status payload (sans the owner's
        fingerprint id, which the engine/router adds)."""
        with self._lock:
            return {
                "dir": self.dir,
                "files": self._list_files(),
                "records": dict(self._records),
                "bytes": self._bytes,
                "dropped": dict(self._dropped),
                "max_bytes": self.max_bytes,
                "max_files": self.max_files,
            }
