"""Typed queries over HTTP under open-loop load.

Set-up builds the IVF-PQ index of the configuration in memory, the
stella encoder from seeded weights with the frozen tokenizer, the
engine (``SearchEngine``, no hydration, the lazy id map) and the port's
own server (``run_server(engine=..., port=0)``: ``ThreadingHTTPServer``
-> ``MicroBatcher`` as shipped -> engine -> encoder -> index -> ids),
warms every batch and sequence shape the traffic reaches, and starts the
load generator (``portbench/loadgen.py``, a process with no torch), which
sends 16 requests one after another through the server before the
window.

The window: requests due at Poisson arrivals of the traffic's fixed
rate, each a distinct typed query of the traffic's word range, sent
whether or not earlier ones returned, each timed from its due time. The
arrival gaps and word counts are one fixed set for every seed, in the
seed's order; the seed picks the words.

The check: a sample of the finished requests drawn from the seed, the
longest among them, embedded again by the plain stella
(``reference/stella.py``) and searched by the plain IVF-PQ judge
(``reference/ivfpq.py``). A request that never came back fails the run.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..harness import ROOT, Slice
from ..reference import ivfpq as ref_ivfpq
from ..reference import stella as ref_stella
from ..yardstick import corpus
from .common import IVFPQInputs, LazyIds, served, sync


def stella_config(enc: dict):
    from abstracts_search_tpu_torch.models.qwen2 import Qwen2Config
    from abstracts_search_tpu_torch.models.stella import StellaConfig

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[enc["dtype"]]
    return StellaConfig(
        backbone=Qwen2Config(vocab_size=enc["vocab_size"], hidden_size=enc["hidden_size"],
                             intermediate_size=enc["intermediate_size"],
                             num_layers=enc["num_hidden_layers"],
                             num_heads=enc["num_attention_heads"],
                             num_kv_heads=enc["num_key_value_heads"], head_dim=enc["head_dim"],
                             rope_theta=enc["rope_theta"], rms_norm_eps=enc["rms_norm_eps"],
                             dtype=dt, param_dtype=dt),
        mrl_dim=enc["mrl_dim"], pooling="mean", causal=True, normalize=True)


class Embedder:
    """The engine's query encoder: the frozen tokenizer and the port's
    ``EmbeddingPipeline`` with power-of-two batch buckets, as the port's
    ``StellaEmbedder`` serves it."""

    def __init__(self, pipeline, prompt: str):
        self.pipeline, self.prompt = pipeline, prompt

    def queries(self, texts):
        return self.pipeline.embed_queries(texts, self.prompt)


def schedule(traffic: dict, seconds: float, seed: int):
    """-> (due times [n] s, word counts [n]): one fixed set of gaps and
    counts (a key of the traffic alone) in the seed's order."""
    n = max(1, int(round(traffic["rate_qps"] * seconds)))
    base = corpus.rng(0, "arrivals", n)
    gaps = base.exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    lo, hi = traffic["words"]
    words = base.integers(lo, hi + 1, n)
    order = corpus.rng(seed, "order")
    gaps, words = gaps[order.permutation(n)], words[order.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due, words


def _batcher_of(server, serve: dict):
    """The MicroBatcher that ``run_server`` built, from the handler's
    closure (its ``search``); refused unless its row cap, window and
    workers are the configuration's ``serve`` ones."""
    from abstracts_search_tpu_torch.serve.batcher import MicroBatcher

    for c in server.RequestHandlerClass.do_GET.__closure__ or ():
        obj = getattr(c.cell_contents, "__self__", None)
        if isinstance(obj, MicroBatcher):
            got = {"micro_batch": obj.max_batch, "window_ms": obj.window_s * 1e3,
                   "workers": len(obj._threads)}
            want = {k: serve[k] for k in got}
            if any(not math.isclose(got[k], want[k]) for k in got):
                raise RuntimeError(f"the server's micro-batcher runs {got}; the "
                                   f"configuration states {want}")
            return obj
    raise RuntimeError("the server runs no micro-batcher")


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.enc = config["encoder"]
        self.tok = corpus.tokenizer(self.enc["vocab_size"])
        self.vocab = corpus.vocabulary()

    # -- set-up ---------------------------------------------------------------------

    def build_encoder(self):
        from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline

        weights = corpus.stella_weights(self.enc, self.seed, self.device)
        pipe = EmbeddingPipeline(stella_config(self.enc), weights, self.tok,
                                 batch_size=self.enc["embed_batch"],
                                 buckets=self.enc["seq_buckets"], batch_buckets=True,
                                 device=self.device)
        del weights
        return Embedder(pipe, self.traffic["prompt"])

    def setup(self) -> None:
        from abstracts_search_tpu_torch.serve.app import run_server
        from abstracts_search_tpu_torch.serve.engine import SearchEngine

        tr = self.traffic
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        self.index = self.inputs.index()
        self.engine = SearchEngine(self.index, LazyIds(), self.build_encoder(),
                                   nprobe=tr["nprobe"], hydrator=None)
        self.warm()
        bound = threading.Event()
        holder = {}

        def on_bound(server):
            holder["server"] = server
            bound.set()

        sv = self.config["serve"]
        self.thread = threading.Thread(
            target=run_server, kwargs=dict(engine=self.engine, port=0, on_bound=on_bound,
                                           micro_batch=True,
                                           micro_batch_workers=sv["workers"]),
            name="portbench-server", daemon=True)
        self.thread.start()
        if not bound.wait(60):
            raise RuntimeError("the server did not bind")
        self.server = holder["server"]
        self.batcher = _batcher_of(self.server, sv)
        self.gen = None
        self.start_loadgen()

    def start_loadgen(self) -> None:
        """The load generator's process (one per window)."""
        self.gen = subprocess.Popen([sys.executable, str(ROOT / "portbench" / "loadgen.py")],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def warm(self) -> None:
        """Every (rows, sequence bucket) the encoder meets under this
        traffic and the index's batch sizes up to the batcher's largest."""
        lo, hi = self.traffic["words"]
        prompt = corpus.PROMPTS[self.traffic["prompt"]]
        by_bucket = {}
        for w in range(lo, hi + 1):
            t = len(self.tok(prompt + " ".join(["w"] * w)))
            b = next((x for x in self.enc["seq_buckets"] if t <= x), self.enc["seq_buckets"][-1])
            by_bucket.setdefault(b, w)
        rows, b = [], 1
        while b <= self.enc["embed_batch"]:
            rows.append(b)
            b *= 2
        for w in by_bucket.values():
            for n in rows:
                texts = corpus.typed_texts(np.full(n, w), self.seed + 1, self.vocab)
                self.engine.search_batch(texts, k=self.traffic["k"])
        q = np.random.default_rng(0).standard_normal((self.config["serve"]["micro_batch"],
                                                      self.index.dim)).astype(np.float32)
        for n in (1, 2, 3, 4, 8, 16, 24, 32, 48, 64):
            self.engine.search_batch_encoded(q[:n], k=self.traffic["k"])
        sync(self.device)

    # -- the window -----------------------------------------------------------------

    def drive(self, due, texts, warm: list, on_go=None) -> list:
        """One open-loop pass of the load generator: ``warm`` requests one
        after another, then ``texts`` at ``due`` seconds from ``t0``;
        ``on_go(t0)`` runs while they are sent. -> its per-request
        records, once every request has come back or timed out."""
        tr = self.traffic
        if self.gen is None or self.gen.poll() is not None:
            self.start_loadgen()
        self.gen.stdin.write(json.dumps({
            "port": self.server.server_address[1], "k": tr["k"], "warm": warm,
            "requests": [[float(d), t] for d, t in zip(due, texts)],
            "drain_s": tr["drain_s"], "threads": tr["client_threads"]}) + "\n")
        self.gen.stdin.flush()
        if self.gen.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        t0 = time.monotonic() + 0.2
        self.gen.stdin.write(f"go {t0!r}\n")
        self.gen.stdin.flush()
        if on_go is not None:
            on_go(t0)
        records = json.loads(self.gen.stdout.readline())
        self.gen.wait()
        return records

    def window(self, seconds: float, run) -> None:
        tr = self.traffic
        self.due, self.words = schedule(tr, seconds, self.seed)
        self.texts = corpus.typed_texts(self.words, self.seed, self.vocab)
        traced = self._trace_on(run) if run.trace else None
        before = dict(self.batcher.stats)
        sl = Slice(run, tr["trace_start"] * seconds, tr["trace_length_s"])
        start = []

        def watch(t0: float) -> None:
            start.append(t0)
            while (now := time.monotonic()) < t0 + seconds:
                sl.poll(now - t0)
                time.sleep(0.01)
            sl.end()

        warm = corpus.typed_texts(np.full(16, tr["words"][0]), self.seed + 2, self.vocab)
        self.records = self.drive(self.due, self.texts, warm, on_go=watch)
        sl.finish()
        after = dict(self.batcher.stats)
        run.counters["batch_requests"] = after["requests"] - before["requests"]
        run.counters["batches"] = after["batches"] - before["batches"]
        if traced is not None:
            traced(start[0], seconds)
        run.window_s = seconds
        run.attempted = len(self.records)
        run.latencies_ms = [(r[2] - r[0]) * 1e3 if r[3] == 200 else math.inf
                            for r in self.records]
        run.failed = sum(1 for r in self.records if r[3] != 200)

    def _trace_on(self, run):
        """Synchronising spans around the engine's encode and search, the
        real tokens of each encode; -> a closure that reads them out."""
        eng = self.engine
        enc_orig, search_orig = eng.encode_queries, eng.search_batch_encoded
        prompt = corpus.PROMPTS[self.traffic["prompt"]]
        cap = self.enc["seq_buckets"][-1]
        tokens = []

        def encode_queries(texts):
            with run.span("encode", sync=lambda: sync(self.device)):
                out = enc_orig(texts)
            with run._lock:
                tokens.append((time.perf_counter(), [min(len(self.tok(prompt + t)), cap)
                                                     for t in texts]))
            return out

        def search_batch_encoded(q, k=10):
            with run.span("search", sync=lambda: sync(self.device)):
                return search_orig(q, k)

        eng.encode_queries, eng.search_batch_encoded = encode_queries, search_batch_encoded

        def done(t0_mono: float, seconds: float) -> None:
            eng.encode_queries, eng.search_batch_encoded = enc_orig, search_orig
            # host clocks: the spans use perf_counter, the window monotonic
            off = time.perf_counter() - time.monotonic()
            lo, hi = t0_mono + off, t0_mono + off + seconds
            run.counters["window_perf"] = (lo, hi)
            run.counters["tokens"] = [ts for t, ts in tokens if lo <= t <= hi]

        return done

    def free(self) -> None:
        self.server.shutdown()
        self.thread.join(timeout=60)
        self.server.server_close()
        del self.engine, self.index, self.server, self.batcher
        if self.gen is not None and self.gen.poll() is None:
            self.gen.kill()
            self.gen.wait()

    # -- the check ------------------------------------------------------------------

    def sample(self, finished: list) -> list:
        """Indices to check: the longest finished requests, then others
        drawn from the seed."""
        tr = self.traffic
        n = min(tr["check_requests"], len(finished))
        longest = sorted(finished, key=lambda i: -self.words[i])[: tr["check_longest"]]
        rest = sorted(set(finished) - set(longest))
        r = corpus.rng(self.seed, "check")
        extra = r.choice(len(rest), max(0, n - len(longest)), replace=False) if rest else []
        return longest + [rest[j] for j in extra]

    def check(self, run) -> dict:
        tr = self.traffic
        lim = tr["limits"]
        finished = [i for i, r in enumerate(self.records) if r[3] == 200]
        pick = self.sample(finished)
        rows = [[{"id": h[0], "score": h[1]} for h in self.records[i][4]] for i in pick]
        got = self.judge([self.texts[i] for i in pick], served(rows))
        return {"missing": (float(run.failed), float(lim["missing"])),
                "score_err": (got["score_err"], lim["score_err"]),
                "rank_gap": (got["rank_gap"], lim["rank_gap"])}

    def judge(self, texts: list, rows: list) -> dict:
        tr = self.traffic
        weights = corpus.stella_weights(self.enc, self.seed, self.device)
        q = ref_stella.embed_texts(texts, self.tok, corpus.PROMPTS[tr["prompt"]], weights,
                                   self.enc)
        del weights
        return ref_ivfpq.judge(self.inputs.reference(), q, rows, tr["nprobe"], tr["k"])

    # -- the control ----------------------------------------------------------------

    def control(self, seconds: float) -> dict:
        """The reference in the program's place one precision down (TF32
        for the f32 encoder and index products), on the requests a run's
        check would draw; judged as a run is. Needs no program."""
        tr = self.traffic
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        self.due, self.words = schedule(tr, seconds, self.seed)
        self.texts = corpus.typed_texts(self.words, self.seed, self.vocab)
        pick = self.sample(list(range(len(self.texts))))
        texts = [self.texts[i] for i in pick]
        weights = corpus.stella_weights(self.enc, self.seed, self.device)
        q = ref_stella.embed_texts(texts, self.tok, corpus.PROMPTS[tr["prompt"]], weights,
                                   self.enc, kind="tf32")
        del weights
        rows = ref_ivfpq.search(self.inputs.reference(), q, tr["nprobe"], tr["k"], "tf32")
        return self.judge(texts, rows)

