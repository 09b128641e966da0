"""The Moonlight cell's traffic (``abstract_batches``: back-to-back calls of
abstract-length texts from one caller, encoded and searched in the
IVF-PQ index) through the configuration's Kimi Linear encoder, which
holds a share of each sparse layer's routed experts.

Set-up, the window and the check are ``abstract_batches``'s; what
differs is the encoder: its tensors and shapes
(``yardstick/kimi_linear.py``: KDA's and NoPE MLA's, the held experts,
KDA's decay parameters as the published initialisation draws them), its
plain reference (``reference/kimi_linear.py``, f32, the held share
alike), and in traced runs the KDA kernel's calls counted and timed
beside the expert kernel's, with the KDA layers' and the expert layers'
work summed on the card after each forward (``last_kda_stats``,
``last_moe_stats``). A program without the Kimi Linear backbone fails at
once, as the cell is made.
"""

from __future__ import annotations

import torch

from ..reference import ivfpq as ref_ivfpq
from ..reference import kimi_linear as ref_kimi
from ..yardstick import corpus
from ..yardstick import kimi_linear as yk
from ..yardstick import moonlight as ym
from . import abstract_batches
from .abstract_batches import experts_cost, stella_config
from .common import IVFPQInputs, OpRanges


def kda_cost(args):
    """kda_scan(q, k, v, g, beta): the shapes of q."""
    b, t, h, d = args[0].shape
    return lambda: yk.kda_cost(b, t, h, d) + ("bf16",)


class Cell(abstract_batches.Cell):
    def __init__(self, config: dict, traffic: dict, *, seed: int, device):
        # the program's Kimi Linear backbone, looked for first: a program
        # without it fails here, before any set-up
        from abstracts_search_tpu_torch.models import kimi_linear  # noqa: F401

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.enc = yk.encoder(config)
        self.tok = corpus.tokenizer(self.enc["vocab_size"])
        self.prompt = ym.PROMPTS[traffic["prompt"]]
        tr = traffic
        self.texts = ym.abstract_texts(tr["pool_calls"] * tr["batch"], seed, corpus.vocabulary(),
                                       **tr["words"])
        self.calls = [self.texts[i * tr["batch"]:(i + 1) * tr["batch"]]
                      for i in range(tr["pool_calls"])]
        r = corpus.rng(seed, "check_calls")
        self.keep = sorted(r.choice(tr["pool_calls"], tr["check_calls"], replace=False).tolist())

    def build_encoder(self):
        """The port's pipeline, given placeholder weights (one zero each,
        expanded), then the seeded tensors written into its own."""
        from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline

        names = yk.shapes(self.enc)
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
                own[n].copy_(yk.tensor(self.seed, n, shape, kind, self.device))
        return pipe

    def _trace_on(self, run, sl):
        """The KDA and expert kernels' calls in profiler ranges of their
        own, counted and timed; the KDA and expert layers' work summed on
        the card after each forward -> a closure that reads it out once
        the window has closed."""
        from abstracts_search_tpu_torch.models import kimi_linear, moonlight

        ranges = [OpRanges(run, "experts", moonlight, "grouped_swiglu", experts_cost, sl.active),
                  OpRanges(run, "kda", kimi_linear, "kda_scan", kda_cost, sl.active)]
        for rng in ranges:
            rng.on = True
        backbone = self.pipe.model.backbone
        forward = self.pipe.forward
        acc = {"pairs": 0, "held_pairs": 0, "kda_tokens": 0,
               "kda_pad": torch.zeros((), dtype=torch.int64, device=self.device)}

        def counted(ids, mask):
            out = forward(ids, mask)
            moe, kda = backbone.last_moe_stats, backbone.last_kda_stats
            acc["pairs"] += moe["pairs"]
            acc["held_pairs"] += moe["held_pairs"]
            acc["kda_tokens"] += kda["tokens"]
            acc["kda_pad"] += kda["pad_tokens"]
            return out

        self.pipe.forward = counted

        def done() -> None:
            del self.pipe.forward
            for rng in ranges:
                rng.close()
            run.counters["moe_pairs"] = acc["pairs"]
            run.counters["moe_held_pairs"] = acc["held_pairs"]
            run.counters["kda_tokens"] = acc["kda_tokens"]
            run.counters["kda_pad_tokens"] = int(acc["kda_pad"])

        return done

    def judge(self, texts: list, mine: torch.Tensor, rows: list) -> dict:
        """The program's (or the control's) embeddings ``mine`` and served
        rows against the reference."""
        tr = self.traffic
        want = ref_kimi.embed_texts(texts, self.tok, self.prompt, self.enc, self.seed,
                                    self.device)
        mine = mine.to(want.device).float()
        cos = (mine * want).sum(1) / (mine.norm(dim=1) * want.norm(dim=1)).clamp_min(1e-12)
        cap = self.enc["seq_buckets"][-1]
        tokens = torch.tensor([min(len(self.tok(self.prompt + t)), cap) for t in texts],
                              dtype=torch.float32, device=cos.device)
        got = ref_ivfpq.judge(self.inputs.reference(), mine, rows, tr["nprobe"], tr["k"])
        return {"token_gap": float(((1.0 - cos) * tokens).mean()), **got}

    def control(self, seconds: float) -> dict:
        """The reference in the program's place with every product's
        operands rounded to 3 mantissa bits (e4m3's), its rows searched by
        the IVF-PQ reference in f32, on the texts a run's check would
        draw; judged as a run is. Needs no program."""
        tr = self.traffic
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        pick = self.sample()
        texts = [self.calls[c][j] for c, j in pick]
        q = ref_kimi.embed_texts(texts, self.tok, self.prompt, self.enc, self.seed, self.device,
                                 "e4m3")
        rows = ref_ivfpq.search(self.inputs.reference(), q, tr["nprobe"], tr["k"], "f32")
        return self.judge(texts, q, rows)
