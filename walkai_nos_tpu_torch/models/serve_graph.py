"""The paged engine's device-resident decode loop (`loop_steps` > 1).

Port of the JAX engine's `_build_loop_program` and
`_build_spec_loop_program` (`walkai_nos_tpu/models/serve.py`): one
dispatch folds up to `loop_steps` decode chunks (`decode_chunk`) or
speculative rounds (`spec_round`) and ends at the first condition the
host must see, with one host sync for the whole fold:

- a live slot emitted its EOS (a chunk: anywhere in the chunk, its input
  column included; a round: in the committed window, or as its input);
- a live slot generated what it is owed (`owed`);
- a live slot's write head would cross into an unbacked row next time
  (`backed`: the host backs every slot to the horizon before the fold,
  so this fires only where the pool ran dry);
- the horizon, `loop_steps` chunks or rounds.

The first chunk always runs. Exit codes as JAX's: 1 slot done, 2
unbacked, 0 horizon. The fold surfaces [slots, 1 + loop_steps * W]
tokens (column 0 the fold's input token; W = chunk_steps, or k+1 for
rounds, where each slot's committed tokens are packed from column 1 on),
the number of chunks or rounds run, the exit code, and for rounds the
per-round commit counts rc [loop_steps, slots].

On the card the fold is a CUDA graph per (plain | spec, k), captured at
its first use. A capture records without running, so what a body needs
must exist before it: the kernels' libraries, K1's and K2's ticket
buffers (made at their first eager call, at least 4096 and 1024 cells;
one that would have to grow during a capture raises) and the cuBLAS
handles. The first fold follows admission's eager dispatches; a fold of
a halved k, or the plain fold after drafting stops, is captured
mid-serving. Each chunk or round is captured by PyTorch as a graph of
its own (the prologue rides with body 0; the captures share one memory
pool), and `csrc/graph_fold.cu` assembles them: body 0 unconditional,
each later body in a conditional IF node whose handle a one-thread
kernel sets from a device flag the body before it wrote (code == 0).
So the fold stops on
the device at its exit, with no work after it. The host uploads the
table and the exit inputs into the graph's static buffers, launches the
graph once, copies the outputs back once and synchronizes once. On the
CPU the same bodies run as a Python loop reading the same flag: the
plain version.

The kernel wrappers count launches when they are called, which in a
graph is once, at capture; the fold takes those capture-time counts back
out and adds, at each replay, each kernel's launches per chunk or round
times the number the replay ran (`LAUNCHES` and `LAUNCHES_AT_STEPS`
alike). `chip_smoke.py`'s profiled windows hold these counts to the
launches the profiler sees.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from walkai_nos_tpu_torch.models.lm import DecoderLM, PagedCache
from walkai_nos_tpu_torch.models.serve_lane import (
    SlotState,
    decode_chunk,
    spec_round,
)
from walkai_nos_tpu_torch.ops import decode_attention as da

__all__ = ["DecodeLoop", "LOOP_EXITS"]

# Exit code -> the `cb_loop_exits_total` reason.
LOOP_EXITS = {0: "horizon", 1: "slot_done", 2: "unbacked"}


class DecodeLoop:
    """The fold of one engine: its static device buffers, its graphs, and
    the counts of folds run and graphs captured."""

    def __init__(
        self, model: DecoderLM, st: SlotState, *, slots: int, nlog: int,
        loop_steps: int, chunk_steps: int, draft: DecoderLM | None = None,
        d_cache: PagedCache | None = None, spec_k: int = 0,
    ) -> None:
        self.model, self.st = model, st
        self.draft, self.d_cache = draft, d_cache
        self.slots, self.nlog = slots, nlog
        self.L, self.cs = loop_steps, chunk_steps
        self.dev = st.index.device
        self.cuda = self.dev.type == "cuda"
        width = 1 + loop_steps * max(chunk_steps, spec_k + 1)
        # Inputs, one int32 upload: table, live, eos, owed, backed.
        n_in = slots * (nlog + 4)
        self._in = torch.zeros(n_in, dtype=torch.int32, device=self.dev)
        views = self._in.split([slots * nlog] + [slots] * 4)
        self.table = views[0].view(slots, nlog)
        self.live, self.eos, self.owed, self.backed = views[1:]
        # Outputs, one int64 download: buf (plus a dump column the
        # rejected positions of a round scatter to), rc, t, code.
        self._width = width
        n_out = slots * (width + 1) + loop_steps * slots + 2
        self._out = torch.zeros(n_out, dtype=torch.int64, device=self.dev)
        views = self._out.split([slots * (width + 1), loop_steps * slots, 1, 1])
        self.buf = views[0].view(slots, width + 1)
        self.rc = views[1].view(loop_steps, slots)
        self.t, self.code = views[2][0], views[3][0]
        self.off = torch.zeros(slots, dtype=torch.int64, device=self.dev)
        self.go = torch.ones((), dtype=torch.bool, device=self.dev)
        if self.cuda:
            self._in_host = torch.empty(n_in, dtype=torch.int32, pin_memory=True)
            self._out_host = torch.empty(n_out, dtype=torch.int64, pin_memory=True)
            self._pool = torch.cuda.graph_pool_handle()
        # spec k (0: plain) -> (graph exec, captured bodies, launches a body)
        self._graphs: dict = {}
        self._execs: list = []
        weakref.finalize(self, _destroy, self._execs)
        self.folds = self.captures = 0

    # -- the body ----------------------------------------------------------

    def _prologue(self) -> None:
        self.buf.zero_()
        self.buf[:, 0].copy_(self.st.tokens)
        self.rc.zero_()
        self.t.zero_()
        self.code.zero_()
        self.off.zero_()
        self.go.fill_(True)

    def _exit(self, done: torch.Tensor, unbacked: torch.Tensor) -> None:
        live = self.live.bool()
        code = torch.where(
            (live & done).any(), 1, torch.where((live & unbacked).any(), 2, 0)
        )
        self.code.copy_(code)
        self.go.copy_(code == 0)

    def _chunk(self, i: int, k: int) -> None:
        """Decode chunk i of the fold (JAX `loop_chunks`' body)."""
        cs, st = self.cs, self.st
        emitted = decode_chunk(self.model, st, self.table, cs)
        self.buf[:, 1 + i * cs:1 + (i + 1) * cs].copy_(emitted[:, 1:])
        self.t.fill_(i + 1)
        done = (emitted == self.eos[:, None]).any(1) | ((i + 1) * cs >= self.owed)
        self._exit(done, st.index + cs > self.backed)

    def _round(self, i: int, k: int) -> None:
        """Speculative round i of the fold (JAX `loop_spec`'s body):
        committed tokens pack from column 1 + off; rejected positions go
        to the dump column."""
        st = self.st
        emitted, n_emit = spec_round(
            self.model, self.draft, st, self.d_cache, self.table, k
        )
        chosen = emitted[:, 1:]
        win = torch.arange(k + 1, device=self.dev)[None]
        valid = win < n_emit[:, None]
        cols = torch.where(valid, 1 + self.off[:, None] + win, self._width)
        self.buf.scatter_(1, cols, chosen)
        self.rc[i].copy_(n_emit)
        self.off += n_emit
        self.t.fill_(i + 1)
        done = (
            ((chosen == self.eos[:, None]) & valid).any(1)
            | (emitted[:, 0] == self.eos) | (self.off >= self.owed)
        )
        self._exit(done, st.index + k + 1 > self.backed)

    # -- one fold ----------------------------------------------------------

    @torch.inference_mode()
    def run(self, table, live, eos, owed, backed, *, spec_k: int = 0):
        """One fold: plain chunks (`spec_k` 0) or rounds of k = spec_k.
        The host arrays are [slots, nlog] and [slots] ints. Returns
        (tokens [slots, 1 + loop_steps * W] int64, chunks or rounds run,
        exit code, rc [loop_steps, slots] or None)."""
        packed = np.concatenate([
            np.asarray(table, np.int32).reshape(-1),
            *(np.asarray(a, np.int32) for a in (live, eos, owed, backed)),
        ])
        body = self._round if spec_k else self._chunk
        self.folds += 1
        if self.cuda:
            exec_, _, per_body = self._graphs.get(spec_k) or self._capture(spec_k, body)
            self._in_host.numpy()[:] = packed
            self._in.copy_(self._in_host, non_blocking=True)
            stream = torch.cuda.current_stream(self.dev)
            da._check(_fold_fn("graph_fold_launch")(exec_, stream.cuda_stream),
                      "graph_fold_launch")
            self._out_host.copy_(self._out, non_blocking=True)
            stream.synchronize()
            out = self._out_host
        else:
            self._in.copy_(torch.from_numpy(packed))
            self._prologue()
            for i in range(self.L):
                if i and not bool(self.go):
                    break
                body(i, spec_k)
            out = self._out
        n = self.slots * (self._width + 1)
        buf = out[:n].view(self.slots, self._width + 1).numpy()
        t_run, code = int(out[-2]), int(out[-1])
        if self.cuda:
            for counts, per in zip((da.LAUNCHES, da.LAUNCHES_AT_STEPS), per_body):
                for key, launches in per.items():
                    counts[key] = counts.get(key, 0) + launches * t_run
        w = self.cs if not spec_k else spec_k + 1
        tokens = buf[:, :1 + self.L * w].copy()
        rc = None
        if spec_k:
            rc = out[n:n + self.L * self.slots].view(self.L, self.slots).numpy().copy()
        return tokens, t_run, code, rc

    def _capture(self, spec_k: int, body):
        """Captures each body of the fold for `spec_k` (body 0 with the
        prologue) and assembles the conditional graph. Returns (graph
        exec, the captured bodies, the kernel launches one body makes:
        (per counter, per (counter, steps)))."""
        counts = (da.LAUNCHES, da.LAUNCHES_AT_STEPS)
        before = [dict(c) for c in counts]
        bodies, per_body = [], None
        for i in range(self.L):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=self._pool):
                if i == 0:
                    self._prologue()
                body(i, spec_k)
            if i == 0:
                per_body = tuple(
                    {key: n - b.get(key, 0) for key, n in c.items() if n != b.get(key, 0)}
                    for c, b in zip(counts, before))
            bodies.append(graph)
        for c, b in zip(counts, before):
            c.clear()
            c.update(b)
        raw = (ctypes.c_void_p * self.L)(*(g.raw_cuda_graph() for g in bodies))
        exec_ = ctypes.c_void_p()
        da._check(_fold_fn("graph_fold_build")(
            raw, self.L, self.go.data_ptr(), ctypes.byref(exec_)),
            "graph_fold_build")
        self._execs.append(exec_.value)
        self.captures += 1
        self._graphs[spec_k] = (exec_.value, bodies, per_body)
        return self._graphs[spec_k]


_FOLD_ARGTYPES = {
    "graph_fold_build": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p],
    "graph_fold_launch": [ctypes.c_void_p, ctypes.c_void_p],
    "graph_fold_destroy": [ctypes.c_void_p],
}


def _fold_fn(name: str):
    return da._kernel_fn("graph_fold", name, _FOLD_ARGTYPES[name])


def _destroy(execs: list) -> None:
    for exec_ in execs:
        _fold_fn("graph_fold_destroy")(exec_)
