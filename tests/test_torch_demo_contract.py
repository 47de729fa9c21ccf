"""The port's demo server answers the JAX demo server's contract.

- `tests/test_demo_server.py`'s cases, one for one, run against child
  processes of `python -m walkai_nos_tpu_torch.app.main` (tiny models,
  the CPU through `WALKAI_DEVICE=cpu`): each JAX fixture's environment,
  and the JAX cases' own bodies and assertions through `port_copy` (the
  HTTP helpers are the port's `utils/httpbench.py`). Two cases build
  their references from the JAX package and are restated on the port's
  own: the concurrent greedy tokens equal an in-process port engine's
  with the server's knobs and seeded weights (bf16, as served), and the
  downloaded capture replays token-identically through the port's
  `cmd/replay.py` on the CPU.
- One pair of child servers, the JAX demo app and the port's, built
  from one environment and sent the same requests in the same order,
  give equal key sets (at every depth) on `/healthz`, `/stats`,
  `/debug/state` and `/debug/slo`, and equal metric names on `/metrics`.

Every child binds a free port, runs in a session of its own, writes its
output to a file under the test's temporary directory and is killed in a
finalizer; every HTTP call has a timeout.
"""

import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu_torch.utils.httpbench import (
    REPO,
    get_json,
    kill_server,
    post_json,
    spawn_server,
)

torch.set_num_threads(1)

JAX_TESTS = port_copy("test_demo_server")
CLASSES = ("TestDemoServer", "TestGenerateEndpoint", "TestSpeculativeEndpoint",
           "TestContinuousBatchingEndpoint", "TestMultiLoraEndpoint")
RESTATED = ("TestContinuousBatchingEndpoint.test_concurrent_generations_are_batched_and_exact",
            "TestContinuousBatchingEndpoint.test_debug_capture_contract_and_replay")
CASES = cases(JAX_TESTS, CLASSES, exclude=RESTATED)

PORT_ENV = {"WALKAI_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
BASE = {"WALKAI_DEMO_MODEL": "tiny", "WALKAI_MAX_BATCH": "8",
        "WALKAI_WARM_BUCKETS": "1", "WALKAI_CALIB_WINDOW_S": "0.2"}
# The environments of test_demo_server.py's fixtures, less JAX_PLATFORMS.
FIXTURE_ENV = {
    "server": {**BASE, "WALKAI_BATCH_WINDOW_MS": "20", "WALKAI_WARM_BUCKETS": "1,8"},
    "lm_server": {**BASE, "WALKAI_DEMO_LM": "1", "WALKAI_LM_MAX_NEW": "8"},
    "spec_server": {**BASE, "WALKAI_DEMO_LM": "1", "WALKAI_DEMO_SPEC": "1",
                    "WALKAI_SPEC_K": "3", "WALKAI_LM_MAX_NEW": "8"},
    "cb_server": {**BASE, "WALKAI_DEMO_LM": "1", "WALKAI_LM_MAX_NEW": "6",
                  "WALKAI_CB_SLOTS": "2", "WALKAI_CB_CHUNK": "2",
                  "WALKAI_SLO_TTFT_P99_S": "60"},
    "lora_server": {**BASE, "WALKAI_DEMO_LM": "1", "WALKAI_LM_MAX_NEW": "6",
                    "WALKAI_CB_SLOTS": "2", "WALKAI_CB_CHUNK": "2",
                    "WALKAI_CB_LORA": "3", "WALKAI_CB_LORA_RANK": "2"},
}


def _spawn(tmp_path_factory, name: str, env: dict, argv=None):
    log = tmp_path_factory.mktemp(name) / "server.log"
    return spawn_server(env, startup_timeout_s=300.0, log_path=str(log),
                        poll_s=0.25, argv=argv)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The port's servers, one per JAX fixture, started on first use."""
    procs, bases = [], {}

    def get(name: str) -> str:
        if name not in bases:
            env = {**FIXTURE_ENV[name], **PORT_ENV}
            if name == "cb_server":
                env["WALKAI_CAPTURE_DIR"] = str(tmp_path_factory.mktemp("capture"))
            proc, bases[name] = _spawn(tmp_path_factory, name, env)
            procs.append(proc)
        return bases[name]

    yield get
    for proc in procs:
        kill_server(proc)


@pytest.fixture
def server(children):
    return children("server")


@pytest.fixture
def lm_server(children):
    return children("lm_server")


@pytest.fixture
def spec_server(children):
    return children("spec_server")


@pytest.fixture
def cb_server(children):
    return children("cb_server")


@pytest.fixture
def lora_server(children):
    return children("lora_server")


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def test_concurrent_generations_are_batched_and_exact(cb_server):
    """JAX's case, its reference restated: the tokens of the port's engine
    built in process with the server's knobs on the server's seeded
    weights."""
    from walkai_nos_tpu_torch.models.decode import cache_bucket
    from walkai_nos_tpu_torch.models.lm import LM_TINY, DecoderLM
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

    engine = ContinuousBatcher(
        LM_TINY, DecoderLM(LM_TINY, device="cpu", seed=0), slots=2,
        cache_len=cache_bucket(64 + 6, LM_TINY.max_seq_len), prompt_bucket=64,
        chunk_steps=2, loop_steps=8, prefill_lanes=4, prefill_chunk=64,
        device="cpu",
    )
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, LM_TINY.vocab_size, n).tolist()
               for n in (3, 5, 4, 6, 2)]
    rids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    want = engine.run()
    results = [None] * len(prompts)

    def hit(i):
        results[i] = post_json(f"{cb_server}/generate", {"prompt": prompts[i]},
                               timeout=120)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    for i, rid in enumerate(rids):
        out = results[i]
        assert out is not None and out.get("batched") is True, out
        assert out["tokens"] == want[rid], (i, out["tokens"], want[rid])


def test_debug_capture_contract_and_replay(cb_server, tmp_path):
    """JAX's case: the capture's status, fingerprint ids, rotation, and a
    download that the port's `cmd/replay.py` replays token-identically on
    the CPU (the server's LM is `DecoderLM(LM_TINY, seed=0)`, exactly
    `--init-seed 0`)."""
    import json

    from walkai_nos_tpu_torch.cmd.replay import main as replay_main

    greedy = post_json(f"{cb_server}/generate", {"prompt": [2, 4, 6]}, timeout=120)
    sampled = post_json(f"{cb_server}/generate",
                        {"prompt": [3, 5], "temperature": 0.7, "seed": 9}, timeout=120)
    status = get_json(f"{cb_server}/debug/capture")["engine"]
    assert status["enabled"] is True
    fp_id = status["fingerprint"]
    assert fp_id and len(fp_id) == 12
    assert greedy["fingerprint"] == fp_id == sampled["fingerprint"]
    assert status["records"]["submit"] >= 2 and status["records"]["done"] >= 2
    assert status["bytes"] > 0
    req = urllib.request.Request(
        f"{cb_server}/debug/capture", data=json.dumps({"action": "rotate"}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        rotated = json.loads(resp.read())["engine"]
    assert len(rotated["files"]) == len(status["files"]) + 1
    with urllib.request.urlopen(f"{cb_server}/debug/capture/download",
                                timeout=30) as resp:
        blob = resp.read().decode()
    saved = tmp_path / "capture-dl.jsonl"
    saved.write_text(blob)
    assert replay_main([str(saved), "--init-seed", "0", "--device", "cpu",
                        "--json"]) == 0


def test_cases_cover_the_jax_module():
    assert len(CASES) + len(RESTATED) == len(cases(JAX_TESTS, CLASSES))
    assert {f"{c}.{n}" for c, n in cases(JAX_TESTS, CLASSES)} >= set(RESTATED)


# -- the JAX app and the port's, side by side ---------------------------------

PAIR_ENV = FIXTURE_ENV["cb_server"]
PAIR_REQUESTS = (
    {"prompt": [1, 2, 3, 4]},
    {"prompt": [5, 6, 7], "max_new_tokens": 3},
    {"prompt": [1, 2, 3], "temperature": 0.8, "top_k": 16, "seed": 42},
    {"prompt": [1] * 80},
)


def _keys(x):
    """The key structure of a JSON value: dicts by their keys at every
    depth, lists by the union of their dict elements' structures."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        shapes = [_keys(v) for v in x if isinstance(v, dict)]
        merged = {}
        for shape in shapes:
            merged.update(shape)
        return [merged] if shapes else []
    return None


def _metrics(base: str) -> str:
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        return resp.read().decode()


def _metric_names(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX app, port app) base URLs, each served PAIR_REQUESTS in order."""
    procs = []
    try:
        jax_proc, jax_base = _spawn(
            tmp_path_factory, "jax_app", {**PAIR_ENV, "JAX_PLATFORMS": "cpu"},
            argv=[sys.executable, f"{REPO}/demos/tpu-sharing-comparison/app/main.py"],
        )
        procs.append(jax_proc)
        port_proc, port_base = _spawn(tmp_path_factory, "port_app",
                                      {**PAIR_ENV, **PORT_ENV})
        procs.append(port_proc)
        deadline = time.monotonic() + 120.0
        for base in (jax_base, port_base):
            for body in PAIR_REQUESTS:
                post_json(f"{base}/generate", body, timeout=120)
            # The SLO gauges refresh at a sync at most once a second of
            # wall time: serve on until they have.
            while "cb_slo_ttft_p99" not in _metrics(base):
                assert time.monotonic() < deadline, f"{base}: no SLO refresh"
                post_json(f"{base}/generate", PAIR_REQUESTS[0], timeout=120)
        yield jax_base, port_base
    finally:
        for proc in procs:
            kill_server(proc)


@pytest.mark.parametrize("path", ["/healthz", "/stats", "/debug/state", "/debug/slo"])
def test_key_sets_equal_jax_app(pair, path):
    jax_base, port_base = pair
    want = _keys(get_json(f"{jax_base}{path}", timeout=30))
    got = _keys(get_json(f"{port_base}{path}", timeout=30))
    assert got == want


def test_metric_names_equal_jax_app(pair):
    want, got = (_metric_names(_metrics(base)) for base in pair)
    assert got == want
    assert "cb_requests_submitted_total" in got
