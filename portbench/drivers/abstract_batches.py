"""Back-to-back calls of abstract-length texts from one caller (a closed
loop), encoded by the configuration's Moonlight encoder and searched in
its IVF-PQ index.

Set-up builds the encoder through the port's ``EmbeddingPipeline`` (a
``StellaEncoder`` over the backbone that the program's own loader,
``registry._backbone_config``, makes of the configuration's
``deepseek_v3`` keys, in bf16, with power-of-two batch buckets as
``StellaEmbedder`` serves it), writes the seeded tensors into it one at
a time (``yardstick/moonlight.py``; no second copy of 31 GB of weights),
builds the IVF-PQ index in memory from the seed and the engine
(``SearchEngine``, no hydration, the lazy id map), makes the pool of
texts and warms each batch shape that the pool's calls plan. A program
without the Moonlight backbone fails at once, as the cell is made.

The window: calls of ``batch`` texts in turn from a pool of
``pool_calls``, each ``embed_queries`` with the traffic's prompt, then
``search_batch_encoded`` at its k and nprobe: the text path of
``run_server``'s batcher, with one caller and no threads.

The check: ``check_texts`` texts drawn from the seed out of
``check_calls`` calls of the first turn, the ``check_longest`` longest
among them. ``token_gap`` is the mean over them of 1 - cos between the
embedding the timed call made and the plain reference's
(``reference/moonlight.py``, f32), times the text's tokens: rounding in
the activations differs from token to token and the mean pooling
averages it, so 1 - cos falls as 1 / tokens and the product holds
steady over lengths and over samples, while coarser weights' products
move every token alike and do not average out. ``score_err`` and
``rank_gap`` judge the rows the call served against the plain IVF-PQ
judge (``reference/ivfpq.py``) over the program's own embeddings, so
the index is held to f32 and the encoder to ``token_gap`` alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..harness import Slice
from ..reference import ivfpq as ref_ivfpq
from ..reference import moonlight as ref_moonlight
from ..yardstick import corpus
from ..yardstick import moonlight as ym
from .common import IVFPQInputs, LazyIds, OpRanges, served, sync

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHECKS = ("token_gap", "score_err", "rank_gap")


def stella_config(enc: dict):
    """The port's StellaConfig over the backbone that its loader makes of
    the ``deepseek_v3`` keys in ``enc``, in ``enc``'s dtype."""
    from abstracts_search_tpu_torch.models import registry
    from abstracts_search_tpu_torch.models.stella import StellaConfig

    dt = DTYPES[enc["dtype"]]
    backbone = dataclasses.replace(registry._backbone_config(enc), dtype=dt, param_dtype=dt)
    return StellaConfig(backbone=backbone, mrl_dim=enc["mrl_dim"], pooling="mean", causal=True,
                        normalize=True)


def experts_cost(args):
    """grouped_swiglu(rows, offsets, w13, w2): the experts with rows,
    counted once the window has closed."""
    rows, offsets, w13 = args[0], args[1], args[2]
    pairs, (_, i2, h) = rows.shape[0], w13.shape
    return lambda: ym.experts_cost(pairs, int((offsets[1:] > offsets[:-1]).sum()), h,
                                   i2 // 2) + ("bf16",)


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device):
        # the program's Moonlight backbone, looked for first: a program
        # without it fails here, before any set-up
        from abstracts_search_tpu_torch.models import moonlight  # noqa: F401

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.enc = ym.encoder(config)
        self.tok = corpus.tokenizer(self.enc["vocab_size"])
        self.prompt = ym.PROMPTS[traffic["prompt"]]
        tr = traffic
        self.texts = ym.abstract_texts(tr["pool_calls"] * tr["batch"], seed, corpus.vocabulary(),
                                       **tr["words"])
        self.calls = [self.texts[i * tr["batch"]:(i + 1) * tr["batch"]]
                      for i in range(tr["pool_calls"])]
        r = corpus.rng(seed, "check_calls")
        self.keep = sorted(r.choice(tr["pool_calls"], tr["check_calls"], replace=False).tolist())

    # -- set-up ---------------------------------------------------------------------

    def build_encoder(self):
        """The port's pipeline, given placeholder weights (one zero each,
        expanded), then the seeded tensors written into its own."""
        from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline

        names = ym.shapes(self.enc)
        zero = torch.zeros((), device=self.device)
        pipe = EmbeddingPipeline(stella_config(self.enc),
                                 {n: zero.expand(shape) for n, shape, _ in names}, self.tok,
                                 batch_size=self.enc["embed_batch"],
                                 buckets=self.enc["seq_buckets"], batch_buckets=True,
                                 device=self.device)
        own = pipe.model.state_dict()
        if set(own) != {n for n, _, _ in names}:
            raise RuntimeError(f"the encoder's tensors differ from the yardstick's: "
                               f"{sorted(set(own) ^ {n for n, _, _ in names})[:8]}")
        with torch.no_grad():
            for n, shape, kind in names:
                own[n].copy_(ym.tensor(self.seed, n, shape, kind, self.device))
        return pipe

    def setup(self) -> None:
        from abstracts_search_tpu_torch.serve.engine import SearchEngine

        tr = self.traffic
        self.pipe = self.build_encoder()
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        self.index = self.inputs.index()
        self.engine = SearchEngine(self.index, LazyIds(), None, nprobe=tr["nprobe"])
        self.warm()

    def warm(self) -> None:
        """Each batch shape that the pool's calls plan, then two calls."""
        shapes = {ids.shape for c in self.calls
                  for _, ids, _ in self.pipe.plan(c, self.traffic["prompt"])}
        for shape in sorted(shapes):
            self.pipe.forward(np.full(shape, 2, np.int64), np.ones(shape, np.int64))
        for c in self.calls[:2]:
            self.call(c)
        sync(self.device)

    def call(self, texts):
        emb = self.pipe.embed_queries(texts, self.traffic["prompt"])
        return emb, self.engine.search_batch_encoded(emb, self.traffic["k"])

    # -- the window -----------------------------------------------------------------

    def window(self, seconds: float, run) -> None:
        tr = self.traffic
        sl = Slice(run, tr["trace_start"] * seconds, tr["trace_length_s"])
        done = self._trace_on(run, sl) if run.trace else None
        self.kept = {}
        n_pool = len(self.calls)
        i = 0
        t0 = time.perf_counter()
        while (el := time.perf_counter() - t0) < seconds:
            sl.poll(el)
            out = self.call(self.calls[i % n_pool])
            if i in self.keep:
                self.kept[i] = out
            i += 1
        sync(self.device)
        run.window_s = time.perf_counter() - t0
        sl.finish()
        if done is not None:
            done()
        run.queries = i * tr["batch"]
        run.attempted = i
        run.counters["batches"] = i
        run.counters["batch"] = tr["batch"]
        cap = self.enc["seq_buckets"][-1]
        lengths = [[min(len(self.tok(self.prompt + t)), cap) for t in c] for c in self.calls]
        run.counters["tokens"] = [t for j in range(i) for t in lengths[j % n_pool]]

    def _trace_on(self, run, sl):
        """The expert kernel's calls in profiler ranges of their own,
        counted and timed; the expert layers' padding counted on the card
        (``last_moe_stats`` after each forward) -> a closure that reads
        it out once the window has closed."""
        from abstracts_search_tpu_torch.models import moonlight

        rng = OpRanges(run, "experts", moonlight, "grouped_swiglu", experts_cost, sl.active)
        rng.on = True
        backbone = self.pipe.model.backbone
        forward = self.pipe.forward
        acc = {"tokens": 0, "pad": torch.zeros((), dtype=torch.int64, device=self.device)}

        def counted(ids, mask):
            out = forward(ids, mask)
            st = backbone.last_moe_stats
            acc["tokens"] += st["tokens"]
            acc["pad"] += st["pad_tokens"]
            return out

        self.pipe.forward = counted

        def done() -> None:
            del self.pipe.forward
            rng.close()
            run.counters["moe_tokens"] = acc["tokens"]
            run.counters["moe_pad_tokens"] = int(acc["pad"])

        return done

    def free(self) -> None:
        for name in ("pipe", "engine", "index"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the check ------------------------------------------------------------------

    def sample(self) -> list:
        """(call, position) pairs to check: the longest texts of the kept
        calls, then others drawn from the seed."""
        tr = self.traffic
        cands = [(c, j) for c in self.keep for j in range(tr["batch"])]
        words = lambda cj: len(self.calls[cj[0]][cj[1]].split())  # noqa: E731
        longest = sorted(cands, key=lambda cj: (-words(cj), cj))[: tr["check_longest"]]
        rest = sorted(set(cands) - set(longest))
        r = corpus.rng(self.seed, "check_texts")
        extra = r.choice(len(rest), min(len(rest), tr["check_texts"] - len(longest)),
                         replace=False)
        return longest + [rest[j] for j in sorted(extra)]

    def check(self, run) -> dict:
        tr = self.traffic
        lim = tr["limits"]
        pick = [cj for cj in self.sample() if cj[0] in self.kept]
        if not pick:
            return {k: (float("inf"), lim[k]) for k in CHECKS}
        texts = [self.calls[c][j] for c, j in pick]
        mine = torch.from_numpy(np.stack([self.kept[c][0][j] for c, j in pick]))
        rows = [served([self.kept[c][1][j]])[0] for c, j in pick]
        got = self.judge(texts, mine, rows)
        return {k: (got[k], lim[k]) for k in CHECKS}

    def judge(self, texts: list, mine: torch.Tensor, rows: list) -> dict:
        """The program's (or the control's) embeddings ``mine`` and served
        rows against the reference."""
        tr = self.traffic
        want = ref_moonlight.embed_texts(texts, self.tok, self.prompt, self.enc, self.seed,
                                         self.device)
        mine = mine.to(want.device).float()
        cos = (mine * want).sum(1) / (mine.norm(dim=1) * want.norm(dim=1)).clamp_min(1e-12)
        cap = self.enc["seq_buckets"][-1]
        tokens = torch.tensor([min(len(self.tok(self.prompt + t)), cap) for t in texts],
                              dtype=torch.float32, device=cos.device)
        got = ref_ivfpq.judge(self.inputs.reference(), mine, rows, tr["nprobe"], tr["k"])
        return {"token_gap": float(((1.0 - cos) * tokens).mean()), **got}

    # -- the control ----------------------------------------------------------------

    def control(self, seconds: float) -> dict:
        """The reference in the program's place with every product's
        operands rounded to 3 mantissa bits (e4m3's), its rows searched by
        the IVF-PQ reference in f32, on the texts a run's check would
        draw; judged as a run is, so the encoder's precision alone is
        what it fails on. Needs no program."""
        tr = self.traffic
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        pick = self.sample()
        texts = [self.calls[c][j] for c, j in pick]
        q = ref_moonlight.embed_texts(texts, self.tok, self.prompt, self.enc, self.seed,
                                      self.device, "e4m3")
        rows = ref_ivfpq.search(self.inputs.reference(), q, tr["nprobe"], tr["k"], "f32")
        return self.judge(texts, q, rows)
