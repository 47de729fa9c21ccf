"""The port's demo server (`walkai_nos_tpu_torch/app/main.py`) against the
JAX package's `ContinuousBatcher`, in process on the CPU.

One `DemoServer` on bridged f32 weights of JAX's `LM_TINY` (context 256,
so a 128-token block can be shared) serves on a port the OS picks, from
a thread of the test process; every test talks to it over HTTP with a
timeout, and a finalizer stops it. Its greedy `/generate` tokens, served
concurrently, streamed as server-sent events and through the
speculative path, must equal JAX's engine's on the same weights and
prompts, and so must a server whose engine runs "int8-sim" KV and
batched speculative rounds (knobs from the environment). `tp_stats()` at
one device equals JAX's, with telemetry on and off. Startup refuses what
the port does not serve: no GPU without `WALKAI_DEVICE=cpu`, and the
tensor-parallel knobs. `httpbench.spawn_server` takes a child for healthy
only once the child itself listens on its port, not when another
process's server answers there.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
from urllib.parse import urlparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.app.main import DemoServer
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.utils import httpbench
from walkai_nos_tpu_torch.utils.httpbench import get_json, post_json

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 8
FIELDS = dict(dtype="float32", max_seq_len=256)
ENV = {
    "WALKAI_DEMO_MODEL": "tiny",
    "WALKAI_DEMO_LM": "1",
    "WALKAI_LM_MAX_NEW": str(NEW),
    "WALKAI_DEMO_SPEC": "1",
    "WALKAI_SPEC_K": "3",
    "WALKAI_CB_SLOTS": "2",
    "WALKAI_CB_CHUNK": "2",
    "WALKAI_CB_BUCKET": "128",
    "WALKAI_MAX_BATCH": "8",
    "WALKAI_WARM_BUCKETS": "1",
    "WALKAI_CALIB_WINDOW_S": "0.2",
}
# The engine the server builds from ENV: cache_bucket(128 + 8, 256).
ENGINE = dict(slots=2, cache_len=256, prompt_bucket=128, chunk_steps=2)


def _prompts():
    """Five prompts; the last two share their first 128-token block."""
    rng = np.random.default_rng(7)
    block = rng.integers(0, 256, 128).tolist()
    return [rng.integers(0, 256, n).tolist() for n in (3, 9, 5)] + [
        block + rng.integers(0, 256, n).tolist() for n in (4, 6)
    ]


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(jlm.LM_TINY, **FIELDS)
    return jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_tokens(params):
    """JAX's engine on the same weights: the greedy tokens of each prompt
    (handed copies of every host array, ROADMAP §3)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        engine = JaxBatcher(dataclasses.replace(jlm.LM_TINY, **FIELDS), params,
                            **ENGINE)
        rids = [engine.submit(np.asarray(p, np.int32), max_new_tokens=NEW)
                for p in _prompts()]
        out = engine.run()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.fixture(scope="module")
def server(params):
    app = DemoServer(ENV, device="cpu",
                     lm_cfg=dataclasses.replace(tlm.LM_TINY, **FIELDS),
                     lm_params=params, log=lambda line: None).start(port=0)
    yield app
    app.stop(timeout=30.0)


def _stream(base: str, payload: dict) -> tuple[int, list]:
    conn = http.client.HTTPConnection(urlparse(base).netloc, timeout=60)
    try:
        conn.request("POST", "/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events = []
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
        return resp.status, events
    finally:
        conn.close()


def test_concurrent_generate_equals_jax(server, jax_tokens):
    prompts = _prompts()
    results = [None] * len(prompts)

    def hit(i):
        results[i] = post_json(f"{server.url}/generate", {"prompt": prompts[i]},
                               timeout=60)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads)
    assert [r["tokens"] for r in results] == jax_tokens
    assert all(r["batched"] is True for r in results)
    # Served again, alone: the shared block is cached now, and hit.
    hits = server.cb_engine.prefix_stats()["block_hits"]
    again = post_json(f"{server.url}/generate", {"prompt": prompts[3]}, timeout=60)
    assert again["tokens"] == jax_tokens[3]
    assert server.cb_engine.prefix_stats()["block_hits"] == hits + 1


def test_stream_equals_jax(server, jax_tokens):
    for prompt, want in zip(_prompts()[::2], jax_tokens[::2]):
        status, events = _stream(server.url, {"prompt": prompt, "stream": True})
        assert status == 200
        assert events[-1]["done"] is True and events[-1]["n_tokens"] == NEW
        assert [t for e in events[:-1] for t in e["tokens"]] == want
        # chunk_steps 2: the tokens arrive over several events.
        assert len(events) - 1 >= 2


def test_speculative_equals_jax(server, jax_tokens):
    for prompt, want in zip(_prompts(), jax_tokens):
        out = post_json(f"{server.url}/generate",
                        {"prompt": prompt, "speculative": True}, timeout=60)
        assert out["speculative"] is True and out["spec_k"] == 3
        assert out["tokens"] == want


def test_engine_knobs_keep_the_tokens(params, jax_tokens):
    """The engine's own knobs through the environment: "int8-sim" KV
    (exact round trip) and batched speculative rounds with the model as
    its own draft (exact in f32) serve JAX's greedy tokens."""
    env = {**ENV, "WALKAI_CB_KV_DTYPE": "int8-sim", "WALKAI_CB_SPEC": "1",
           "WALKAI_CB_SPEC_DRAFT": "self", "WALKAI_CB_SPEC_K": "2"}
    app = DemoServer(env, device="cpu", lm_cfg=dataclasses.replace(tlm.LM_TINY, **FIELDS),
                     lm_params=params, log=lambda line: None).start(port=0)
    try:
        got = [post_json(f"{app.url}/generate", {"prompt": p}, timeout=60)["tokens"]
               for p in _prompts()[:3]]
        stats = get_json(f"{app.url}/stats", timeout=30)
    finally:
        app.stop(timeout=30.0)
    assert got == jax_tokens[:3]
    assert stats["cb_quant"]["kv_dtype"] == "int8-sim"
    assert stats["cb_spec"]["enabled"] is True


def test_stats_sections_at_one_device(server):
    stats = get_json(f"{server.url}/stats", timeout=30)
    assert stats["device_kind"] == "cpu" and stats["peak_bf16_flops"] is None
    assert stats["cb_tp"] == server.cb_engine.tp_stats()
    state = get_json(f"{server.url}/debug/state", timeout=30)["engine"]
    assert state["tp"]["tp_devices"] == 1


@pytest.mark.parametrize("obs", [True, False], ids=["obs", "no_obs"])
def test_tp_stats_equal_jax(params, obs):
    jcfg = dataclasses.replace(jlm.LM_TINY, **FIELDS)
    tcfg = dataclasses.replace(tlm.LM_TINY, **FIELDS)
    want = JaxBatcher(jcfg, params, obs=obs, **ENGINE).tp_stats()
    got = ContinuousBatcher(tcfg, params, obs=obs, device="cpu", **ENGINE).tp_stats()
    assert got == want
    assert got["enabled"] is False and got["tp_devices"] == 1
    assert got["kv_layout"] is None
    assert got["param_shard_bytes"] == got["param_bytes"]
    assert got["ici_bytes_per_token"] == 0
    assert ("obs_disabled" in got) is (not obs)


@pytest.mark.parametrize("knob", [{"WALKAI_CB_TP": "2"}, {"WALKAI_TP_EMULATE": "4"}],
                         ids=["cb_tp", "tp_emulate"])
def test_tensor_parallel_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        DemoServer({**ENV, **knob}, device="cpu", log=lambda line: None)


def _run_main(env: dict, tmp_path) -> tuple[int, str]:
    """`python -m walkai_nos_tpu_torch.app.main` in a session of its own,
    output to a file; it must exit at startup."""
    log = tmp_path / "server.log"
    base = {k: v for k, v in os.environ.items() if not k.startswith("WALKAI_")}
    with open(log, "wb") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "walkai_nos_tpu_torch.app.main"],
            cwd=ROOT, env={**base, "PYTHONPATH": ROOT, "PORT": "0", **env},
            stdin=subprocess.DEVNULL, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True, timeout=120,
        )
    return proc.returncode, log.read_text()


def test_main_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    rc, out = _run_main({"WALKAI_DEMO_MODEL": "tiny"}, tmp_path)
    assert rc != 0
    assert "no CUDA device is available" in out


def test_main_refuses_tensor_parallel(tmp_path):
    rc, out = _run_main({"WALKAI_DEVICE": "cpu", "WALKAI_DEMO_MODEL": "tiny",
                         "WALKAI_CB_TP": "2"}, tmp_path)
    assert rc != 0
    assert "NotImplementedError" in out and "WALKAI_CB_TP" in out


# A child that answers every GET with an empty JSON object on $PORT.
_ANSWERING_CHILD = (
    "import os, http.server as h\n"
    "class H(h.BaseHTTPRequestHandler):\n"
    "    def do_GET(self):\n"
    "        self.send_response(200); self.end_headers(); self.wfile.write(b'{}')\n"
    "    def log_message(self, *a): pass\n"
    "h.HTTPServer(('0.0.0.0', int(os.environ['PORT'])), H).serve_forever()\n"
)


def test_spawn_server_returns_once_its_child_listens(tmp_path):
    proc, base = httpbench.spawn_server(
        {}, startup_timeout_s=60.0, log_path=str(tmp_path / "child.log"),
        poll_s=0.05, argv=[sys.executable, "-c", _ANSWERING_CHILD])
    try:
        assert get_json(f"{base}/healthz", timeout=10.0) == {}
    finally:
        httpbench.kill_server(proc)
    assert proc.poll() is not None


@pytest.fixture()
def squatter():
    """Another process's server, answering /healthz on a port of its own."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(10.0)
    assert not thread.is_alive()


def test_spawn_server_ignores_another_server_on_its_port(tmp_path, monkeypatch,
                                                         squatter):
    """The port taken between `free_port()` and the child's bind: the
    squatter's /healthz answers, but the child never listens, so it is
    not healthy."""
    monkeypatch.setattr(httpbench, "free_port", lambda: squatter)
    with pytest.raises(RuntimeError, match="never became healthy"):
        httpbench.spawn_server(
            {}, startup_timeout_s=2.0, log_path=str(tmp_path / "child.log"),
            poll_s=0.05, argv=[sys.executable, "-c", "import time; time.sleep(60)"])
