"""The port's ViT micro-batcher (`models/vit_serving.py`) against the
demo's `/infer` core, on the CPU.

The demo module (`demos/tpu-sharing-comparison/app/main.py`) imports only
the standard library at its top, so its `_bucket` and `_Stats` are
loaded from the file and compared with the port's. The server runs
VIT_TINY on the CPU: requests are answered, coalesced up to `max_batch`,
counted, and every fence (None on the CPU) completes.
"""

import importlib.util
import pathlib
import sys
import threading

import pytest
import torch

from walkai_nos_tpu_torch.models import vit_serving as vs
from walkai_nos_tpu_torch.models.vit import VIT_TINY, ViTDetector

torch.set_num_threads(1)

DEMO = (
    pathlib.Path(__file__).resolve().parent.parent
    / "demos" / "tpu-sharing-comparison" / "app" / "main.py"
)


@pytest.fixture(scope="module")
def demo():
    spec = importlib.util.spec_from_file_location("_demo_main", DEMO)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name)
    return mod


@pytest.mark.parametrize("max_batch", [1, 8, 32, 128])
def test_bucket_matches_the_demo(demo, max_batch):
    for n in range(1, 140):
        assert vs._bucket(n, max_batch) == demo._bucket(n, max_batch)


def test_stats_match_the_demo(demo):
    ours, theirs = vs._Stats(), demo._Stats()
    for s in (ours, theirs):
        s.wait_started()
        s.wait_ended()
        s.mark_dispatch()
        s.mark_dispatch()
        s.record(5, 2, 3, 10.0)
        s.mark_fenced(1)
        s.record(8, 1, 0, 16.0)
        s.mark_fenced(1)
    a, b = ours.snapshot(), theirs.snapshot()
    for key in ("images", "requests", "batches", "flops", "padded_images"):
        assert a[key] == b[key], key
    assert a["images"] == 13 and a["padded_images"] == 3 and a["batches"] == 2
    assert ours.inflight == 0 and ours.device_idle_since is not None


@pytest.fixture(scope="module")
def model():
    return ViTDetector(VIT_TINY, device="cpu", seed=0)


def _serve(model, sizes, *, max_batch=8, threads=4, **kw):
    server = vs.ViTServer(VIT_TINY, model, max_batch=max_batch, window_ms=20.0,
                          device="cpu", **kw)
    reqs, lock = [], threading.Lock()

    def client(chunk):
        for n in chunk:
            r = server.submit(n)
            with lock:
                reqs.append(r)

    with server:
        workers = [threading.Thread(target=client, args=(sizes[i::threads],))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
        for r in reqs:
            assert r.done.wait(timeout=60)
    return server, reqs


def test_serves_every_request_and_counts(model):
    sizes = [1, 3, 2, 5, 1, 8, 4, 2, 7, 1, 6, 3]
    server, reqs = _serve(model, sizes)
    snap = server.stats.snapshot()
    assert snap["requests"] == len(sizes)
    assert snap["images"] == sum(sizes)
    assert 1 <= snap["batches"] <= len(sizes)
    assert all(r.batched_with >= r.n_images and r.elapsed > 0 for r in reqs)
    assert all(r.batched_with <= 8 for r in reqs)  # never past max_batch
    # padded images = buckets dispatched - images served.
    buckets = snap["images"] + snap["padded_images"]
    assert buckets >= snap["images"]
    for bucket, out in server.last_outputs.items():
        assert out["logits"].shape == (bucket, VIT_TINY.num_det_tokens, VIT_TINY.num_classes)
        assert torch.isfinite(out["logits"]).all()
    assert server.stats.inflight == 0


def test_coalesces_concurrent_requests_up_to_max_batch(model):
    """Requests queued while the dispatcher holds its window ride one
    batch; one that would overflow the bucket waits for the next. The
    first request waits only 1 ms for company (the demo's lone-request
    hold), so a scheduler stall of that length on a loaded machine can
    split the batch: the grouping is asserted on the first of three
    attempts that shows no such stall, the invariants on every one."""
    groupings = []
    for _ in range(3):
        server = vs.ViTServer(VIT_TINY, model, max_batch=8, window_ms=200.0,
                              device="cpu", interactive_max=0)
        reqs = [server.submit(n) for n in (3, 2, 2, 4)]
        with server:
            for r in reqs:
                assert r.done.wait(timeout=60)
        snap = server.stats.snapshot()
        assert snap["images"] == 11 and all(r.batched_with <= 8 for r in reqs)
        groupings.append(([r.batched_with for r in reqs], snap["batches"],
                          snap["padded_images"]))
        if groupings[-1][0] == [7, 7, 7, 4]:
            break
    assert groupings[-1] == ([7, 7, 7, 4], 2, 1), groupings


def test_outputs_match_the_model_on_the_bucket_input(model):
    server, _ = _serve(model, [2, 2], threads=1, bf16_weights=False)
    for bucket, out in server.last_outputs.items():
        with torch.no_grad():
            want = model(server.images_of(bucket))
        torch.testing.assert_close(out["boxes"], want["boxes"])


def test_calibrate_reports_a_ceiling(model):
    infer = vs.make_infer_step(VIT_TINY, device="cpu")
    rtt, ceiling = vs.calibrate(infer, model, torch.zeros(2, 64, 64, 3),
                                window_s=0.05)
    assert rtt >= 0 and ceiling > 0


def test_close_serves_what_is_queued_and_stops_every_thread(model):
    server = vs.ViTServer(VIT_TINY, model, device="cpu").start()
    threads = list(server._threads)
    reqs = [server.submit(n) for n in (1, 30, 2)]
    server.close()
    assert all(r.done.is_set() for r in reqs)
    assert len(threads) == 1 + 8 and not any(t.is_alive() for t in threads)
