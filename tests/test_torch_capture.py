"""The port's capture log (`walkai_nos_tpu_torch/obs/capture.py`) against
the JAX package's (`walkai_nos_tpu/obs/capture.py`), on the CPU.

The cases of `tests/test_capture_replay.py::TestCaptureLog`, each driven
through both packages' `CaptureLog` on the same calls: the stats must be
equal and the files byte for byte, except each header's
`created_unix_s`; both packages' `load_capture` must read either
package's files the same. `token_digest`, `fingerprint_id` and
`tree_crc32` must equal JAX's on the same values, bf16 leaves included
(numpy arrays of `ml_dtypes.bfloat16`, and torch bf16 tensors).
"""

import builtins
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.obs import capture as jcap
from walkai_nos_tpu.sim import replay as jrep
from walkai_nos_tpu_torch.models import lora as tlora
from walkai_nos_tpu_torch.obs import capture as tcap
from walkai_nos_tpu_torch.sim import replay as trep

PKGS = {"jax": (jcap, jrep), "port": (tcap, trep)}


def _normalized(directory) -> dict[str, list]:
    """{file name: its lines as objects}, headers' `created_unix_s` at 0
    (a line that is no JSON object stays a string)."""
    out = {}
    for name in sorted(os.listdir(directory)):
        rows = []
        with open(os.path.join(directory, name)) as f:
            for line in f.read().splitlines():
                try:
                    obj = json.loads(line)
                except ValueError:
                    rows.append(line)
                    continue
                if isinstance(obj, dict) and obj.get("kind") == "header":
                    obj["created_unix_s"] = 0
                rows.append(obj)
        out[name] = rows
    return out


def _raw_except_created(directory) -> dict[str, str]:
    """Each file's bytes with the header's `created_unix_s` value cut."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            text = f.read()
        out[name] = "\n".join(
            line.split('"created_unix_s": ')[0] if '"kind": "header"' in line
            else line
            for line in text.splitlines()
        )
    return out


def _stats(log) -> dict:
    """`stats()` less the directory and the byte tally: a header's
    `created_unix_s` prints in a varying number of digits."""
    return {k: v for k, v in log.stats().items() if k not in ("dir", "bytes")}


def _both(tmp_path, scenario):
    """Run `scenario(capture module, replay module, directory)` once per
    package in its own directory; the directories must hold the same
    files; returns {pkg: scenario's result}."""
    out = {}
    for pkg, (cap, rep) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = scenario(cap, rep, d)
    assert _raw_except_created(tmp_path / "jax") == _raw_except_created(
        tmp_path / "port"
    )
    return out


def _loaded(capture) -> dict:
    """A `Capture` of either package as plain data (file paths cut)."""
    return {
        "fingerprint": capture.fingerprint,
        "records": [dataclasses.asdict(r) for r in capture.records],
        "skipped": capture.skipped,
        "runs": capture.runs,
        "run": capture.run,
        "mirrored_skipped": capture.mirrored_skipped,
    }


def _load_everywhere(directory, **kw) -> dict:
    """The capture at `directory` as both packages' loaders read it; they
    must agree."""
    got = {pkg: _loaded(rep.load_capture(str(directory), **kw))
           for pkg, (_, rep) in PKGS.items()}
    assert got["jax"] == got["port"]
    return got["port"]


def test_rotation_bounds_the_ring(tmp_path):
    def scenario(cap, rep, d):
        log = cap.CaptureLog(str(d), max_bytes=400, max_files=2)
        log.attach({"id": "t" * 12})
        for i in range(60):
            log.record_submit(rid=i, prompt=[1, 2, 3], arrival_s=0.0)
        return _stats(log)

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"]
    stats = out["port"]
    assert len(stats["files"]) <= 2
    assert stats["dropped"]["rotated"] > 0
    for d in ("jax", "port"):
        loaded = _load_everywhere(tmp_path / d)
        assert loaded["fingerprint"]["id"] == "t" * 12
        assert 1 <= len(loaded["records"]) <= 60 - loaded["skipped"]


def test_every_file_carries_a_header(tmp_path):
    def scenario(cap, rep, d):
        log = cap.CaptureLog(str(d), max_bytes=300, max_files=8)
        log.attach({"id": "h" * 12})
        for i in range(30):
            log.record_submit(rid=i, prompt=[7], arrival_s=float(i))
        return [os.path.basename(p) for p in log.files()]

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"] and len(out["port"]) > 2
    for rows in _normalized(tmp_path / "port").values():
        assert rows[0]["kind"] == "header"
        assert rows[0]["fingerprint"]["id"] == "h" * 12


@pytest.mark.parametrize("body", [
    b"", b"{}", b'{"action": "rotate"}', b'{"action": "flush"}', b"[1, 2]",
    b"{not json",
], ids=["empty", "default", "rotate", "unknown", "list", "malformed"])
def test_rotate_endpoint_semantics(tmp_path, body):
    def scenario(cap, rep, d):
        log = cap.CaptureLog(str(d))
        log.attach({"id": "r" * 12})
        log.record_submit(rid=0, prompt=[1], arrival_s=0.0)
        n0 = len(log.stats()["files"])
        log.rotate()
        try:
            action = cap.rotate_action_from_body(body)
        except ValueError as bad:
            action = ("ValueError", str(bad).split(":")[0])
        return n0, len(log.stats()["files"]), action

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"]
    n0, n1, _ = out["port"]
    assert n1 == n0 + 1


def test_malformed_lines_skipped_not_fatal(tmp_path):
    def scenario(cap, rep, d):
        log = cap.CaptureLog(str(d))
        log.attach({"id": "m" * 12})
        log.record_submit(rid=0, prompt=[1], max_new_tokens=2, arrival_s=0.0)
        log.record_done(rid=0, tokens=[5, 6], digest=cap.token_digest([5, 6]))
        with open(log.files()[0], "a") as f:
            f.write("{not json\n")
            f.write('{"kind": "mystery"}\n')
            f.write('{"kind": "done", "rid": 99, "tokens": [1]}\n')
        return _stats(log)

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"]
    loaded = _load_everywhere(tmp_path / "port")
    # 2 malformed/unknown lines + 1 orphan done (no submit).
    assert loaded["skipped"] == 3
    assert [r["tokens"] for r in loaded["records"]] == [[5, 6]]


def test_missing_and_headerless_captures_raise(tmp_path):
    p = tmp_path / "capture-000001.jsonl"
    p.write_text('{"kind": "submit", "rid": 0}\n')
    for _, rep in PKGS.values():
        with pytest.raises(FileNotFoundError):
            rep.load_capture(str(tmp_path / "nope"))
        with pytest.raises(ValueError, match="header"):
            rep.load_capture(str(tmp_path))


def test_unwritable_dir_never_raises(tmp_path):
    out = {}
    for pkg, (cap, _) in PKGS.items():
        blocker = tmp_path / f"occupied-{pkg}"
        blocker.write_text("not a directory")
        log = cap.CaptureLog(str(blocker))
        log.attach({"id": "x" * 12})  # open fails silently
        log.record_submit(rid=0, prompt=[1], arrival_s=0.0)
        log.record_done(rid=0, tokens=[2], digest=cap.token_digest([2]))
        out[pkg] = _stats(log)
    assert out["jax"] == out["port"]
    assert out["port"]["dropped"]["write_error"] == 2
    assert out["port"]["records"] == {"submit": 0, "done": 0}


def test_multi_run_capture_is_split_not_merged(tmp_path):
    def scenario(cap, rep, d):
        for prompt, tokens in (([1, 1], [5, 6]), ([2, 2], [7, 8])):
            log = cap.CaptureLog(str(d))  # the second: a restarted server
            log.attach({"id": "f" * 12})
            log.record_submit(rid=0, prompt=prompt, max_new_tokens=2,
                              arrival_s=0.0)
            log.record_done(rid=0, tokens=tokens,
                            digest=cap.token_digest(tokens))
        return None

    _both(tmp_path, scenario)
    for d in ("jax", "port"):
        latest = _load_everywhere(tmp_path / d)
        assert latest["runs"] == 2 and latest["run"] == 1
        assert [r["tokens"] for r in latest["records"]] == [[7, 8]]
        earlier = _load_everywhere(tmp_path / d, run=0)
        assert [r["tokens"] for r in earlier["records"]] == [[5, 6]]
        for _, rep in PKGS.values():
            with pytest.raises(ValueError, match="out of range"):
                rep.load_capture(str(tmp_path / d), run=5)


def test_failed_header_write_closes_fd_and_removes_stray(tmp_path, monkeypatch):
    """ENOSPC-shaped failure: the exclusive create succeeds but the header
    write raises; the fd closes and the stray file goes, in both."""
    out = {}
    for pkg, (cap, _) in PKGS.items():
        d = tmp_path / pkg
        log = cap.CaptureLog(str(d))
        log.attach({"id": "e" * 12})
        closed = []

        class _BadFile:
            def write(self, s):
                raise OSError("no space left on device")

            def flush(self):
                pass

            def close(self):
                closed.append(True)

        real_open = builtins.open

        def fake_open(path, mode="r", *a, **k):
            if mode == "x":
                real_open(path, "x").close()  # metadata succeeds
                return _BadFile()
            return real_open(path, mode, *a, **k)

        n_files_before = len(log.stats()["files"])
        monkeypatch.setattr(builtins, "open", fake_open)
        for _ in range(3):
            log.rotate()
            log.record_submit(rid=0, prompt=[1], arrival_s=0.0)
        monkeypatch.undo()
        stats = _stats(log)
        assert len(closed) >= 3
        assert len(stats["files"]) <= n_files_before
        out[pkg] = (stats, len(closed))
    assert out["jax"] == out["port"]
    assert out["port"][0]["dropped"]["write_error"] == 3


def test_prune_spares_foreign_ring_and_counts_expired(tmp_path):
    header = '{"kind": "header", "fingerprint": {"id": "%s"}}\n'
    submit = '{"kind": "submit", "rid": %d, "prompt": [1]}\n'

    def scenario(cap, rep, d):
        for i in (1, 2):  # an overlapping writer's ring
            (d / f"capture-{i:06d}.jsonl").write_text(
                header % ("o" * 12) + submit % 0 + submit % 1
            )
        log = cap.CaptureLog(str(d), max_bytes=200, max_files=2)
        log.attach({"id": "n" * 12})
        for i in range(10):
            log.record_submit(rid=i, prompt=[2, 3], arrival_s=0.0)
        first = _stats(log)
        assert (d / "capture-000001.jsonl").exists()
        assert (d / "capture-000002.jsonl").exists()
        for i in (3, 4, 5):  # dead runs push the dir past 2x the ring
            (d / f"capture-1{i:05d}.jsonl").write_text(
                header % ("d" * 12) + submit % 0 + submit % 1
            )
        log.rotate()
        return first, _stats(log)

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"]
    first, last = out["port"]
    assert first["dropped"]["rotated"] > 0
    assert len(last["files"]) <= 4
    assert last["dropped"]["rotated"] >= first["dropped"]["rotated"] + 2


def test_from_env_is_the_one_arming_rule(tmp_path):
    env = {
        "WALKAI_CAPTURE_DIR": str(tmp_path),
        "WALKAI_CAPTURE_MAX_BYTES": "1234",
        "WALKAI_CAPTURE_MAX_FILES": "7",
    }
    for cap, _ in PKGS.values():
        log = cap.CaptureLog.from_env(env)
        assert (log.dir, log.max_bytes, log.max_files) == (str(tmp_path), 1234, 7)
        assert cap.CaptureLog.from_env({}) is None
        with pytest.raises(ValueError, match="capture must be"):
            cap.CaptureLog.coerce(12345)
        with pytest.raises(ValueError, match="must be > 0"):
            cap.CaptureLog(str(tmp_path), max_bytes=0)


def test_concurrent_process_never_truncates_a_live_file(tmp_path):
    def scenario(cap, rep, d):
        victim = d / "capture-000001.jsonl"
        victim.write_text('{"kind": "header", "fingerprint": '
                          '{"id": "aaaaaaaaaaaa"}}\n')
        log = cap.CaptureLog(str(d))  # the next sequence would be 2
        (d / "capture-000002.jsonl").write_text("other live\n")
        log.attach({"id": "b" * 12})
        log.record_submit(rid=0, prompt=[1], arrival_s=0.0)
        assert (d / "capture-000002.jsonl").read_text() == "other live\n"
        assert victim.read_text().startswith('{"kind": "header"')
        return log.stats()["files"][-1]

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"] == "capture-000003.jsonl"


def test_full_records_load_across_packages(tmp_path):
    """Engine-shaped submit and done records, with a fingerprint and
    every field the engines write: each package's file loads in the
    other's reader to the same capture, arrival order and all."""
    fp = {"version": 1, "cfg": {"vocab_size": 64, "dtype": "float32"},
          "engine": {"slots": 2}, "weights_crc32": 123}

    def scenario(cap, rep, d):
        body = dict(fp, id=cap.fingerprint_id(fp))
        log = cap.CaptureLog(str(d), max_bytes=700)
        log.attach(body)
        for rid, arrival in ((2, 0.5), (0, 0.25), (1, 0.25)):
            log.record_submit(rid=rid, trace_id=f"t{rid}", prompt=[rid] * 9,
                              max_new_tokens=3, eos_id=None,
                              temperature=0.8 * (rid % 2), top_k=40,
                              top_p=1.0, seed=rid, arrival_s=arrival,
                              adapter=rid % 2)
        for rid in (1, 2):
            toks = [rid, rid + 1, 3]
            log.record_done(rid=rid, trace_id=f"t{rid}", tokens=toks,
                            n_tokens=3, digest=cap.token_digest(toks),
                            ttft_s=0.01, wall_s=0.02, truncated=False,
                            reason="budget")
        # Nothing pruned: the byte tally is what the files hold.
        assert log.stats()["bytes"] == sum(os.path.getsize(p) for p in log.files())
        return _stats(log)

    out = _both(tmp_path, scenario)
    assert out["jax"] == out["port"]
    loaded = _load_everywhere(tmp_path / "jax")
    assert loaded == _load_everywhere(tmp_path / "port")
    assert [r["rid"] for r in loaded["records"]] == [0, 1, 2]
    assert loaded["records"][0]["tokens"] is None  # never completed
    assert loaded["records"][1]["adapter"] == 1


@pytest.mark.parametrize("tokens", [[], [0], [1, 2, 3], [1, 2, 4],
                                    list(range(1000)), [2**31 - 1, -5]])
def test_token_digest_matches_jax(tokens):
    assert tcap.token_digest(tokens) == jcap.token_digest(tokens)
    assert tcap.token_digest(np.asarray(tokens, np.int64)) == jcap.token_digest(tokens)


@pytest.mark.parametrize("fp", [
    {"cfg": {"a": 1}, "engine": {"b": 2}},
    {"cfg": {"a": 1}, "engine": {"b": 2}, "id": "ignored"},
    {"version": 1, "cfg": {"dtype": "bfloat16", "x": None, "y": 1e-6},
     "engine": {"spec": True, "k": [1, 2]}, "weights_crc32": 2**32 - 1,
     "lora": {"digests": {"1": 5}}},
], ids=["plain", "with-id", "nested"])
def test_fingerprint_id_matches_jax(fp):
    assert tcap.fingerprint_id(fp) == jcap.fingerprint_id(fp)
    assert tcap.fingerprint_id(fp) == tcap.fingerprint_id({**fp, "id": "x"})


def _tree(kind):
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "bf16": {"block0": {"qkv": {"kernel": f32}}, "norm": {"scale": f32[0]}},
        "f32": {"b": {"kernel": f32, "bias": f32[:, 0]}, "a": f32[1:2]},
        "int8": {"block0": {"fc1": {"kernel": (f32 * 40).astype(np.int8),
                                    "scale": np.abs(f32[0])}}},
        "int32": {"t": np.arange(12, dtype=np.int32).reshape(3, 4),
                  "e": np.zeros((0, 4), np.int32)},
    }[kind]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int32"])
def test_tree_crc32_matches_jax(kind):
    """bf16: the JAX digest of numpy `bfloat16` leaves (ml_dtypes, what
    `np.asarray` of a jax bf16 array gives) equals the port's digest of
    torch bf16 tensors with the same bits, and of the numpy arrays."""
    tree = _tree(kind)

    def leaves(t, fn):
        return {k: leaves(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}

    if kind == "bf16":
        jtree = leaves(tree, lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)))
        ttree = leaves(tree, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    else:
        jtree, ttree = tree, leaves(tree, torch.from_numpy)
    want = jcap.tree_crc32(jtree)
    assert tcap.tree_crc32(ttree) == want
    assert tcap.tree_crc32(jtree) == want
    assert tcap.tree_crc32(leaves(ttree, lambda t: t.t().contiguous().t() if t.dim() == 2 else t)) == want


def test_tree_crc32_is_order_independent_and_has_one_home():
    a = {"x": np.ones(3, np.float32), "y": np.zeros(2, np.float32)}
    b = {"y": torch.zeros(2), "x": torch.ones(3)}
    assert tcap.tree_crc32(a) == tcap.tree_crc32(b) == jcap.tree_crc32(a)
    assert tlora.tree_crc32 is tcap.tree_crc32
