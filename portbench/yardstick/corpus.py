"""Inputs made from the seed: the IVF-PQ corpus and its trained state,
the flat shard, the fill's rows, the encoder's weights and typed texts.

Both sides get these: the program through its own entry points, the
plain references in ``reference/`` after the window. Nothing here imports
the program. ``list_sizes``, the tokenizer and the seeded codes are
frozen copies of what the port's on-card smoke used, so no later change
to the program moves them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib

import numpy as np
import torch

# stella's config_sentence_transformers.json prompts (the query side)
PROMPTS = {
    "s2p_query": ("Instruct: Given a web search query, retrieve relevant passages "
                  "that answer the query.\nQuery: "),
}
# segments of codes made by one generator call: one staging chunk of the
# install (256 MiB of [64, 256] u8 segments), so no slice splits a block
CODE_BLOCK_SEGS = 16_384


def derive(seed: int, *parts) -> int:
    """A 63-bit generator key for ``parts`` under ``seed``: any whole
    number (negative or past 64 bits) gives a valid, distinct key."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *parts, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *parts))


def tokenizer(vocab_size: int):
    """Whitespace words hashed into the vocabulary by crc32 (ids from 2;
    an empty text is [1]): the same ids in every process."""

    def tok(text: str) -> list[int]:
        return [zlib.crc32(w.encode()) % (vocab_size - 2) + 2 for w in text.split()] or [1]

    return tok


# -- the IVF-PQ corpus ----------------------------------------------------------


def list_sizes(n_rows: int, seed: int, n_lists: int) -> np.ndarray:
    """Lognormal (sigma 1) list sizes summing to n_rows, each >= 1: the
    mass-weighted mean list is ~e times the plain mean, like real IVF
    lists under skewed data."""
    w = rng(seed, "list_sizes").lognormal(0.0, 1.0, n_lists)
    raw = w / w.sum() * (n_rows - n_lists)
    sizes = np.floor(raw).astype(np.int64) + 1
    short = n_rows - int(sizes.sum())
    sizes[np.argsort(raw - np.floor(raw))[::-1][:short]] += 1
    return sizes


@dataclasses.dataclass
class Layout:
    """Lists cut into segments of ``seg`` rows, list after list."""

    sizes: np.ndarray       # [n_lists] rows
    seg_cnt: np.ndarray     # [n_lists] segments
    seg_start: np.ndarray   # [n_lists] first segment
    seg_valid: np.ndarray   # [n_segs] live rows
    seg: int

    @property
    def n_segs(self) -> int:
        return int(self.seg_cnt.sum())

    @classmethod
    def of(cls, sizes: np.ndarray, seg: int) -> "Layout":
        sizes = np.asarray(sizes, np.int64)
        seg_cnt = -(-sizes // seg)
        seg_start = np.concatenate([[0], np.cumsum(seg_cnt)[:-1]]).astype(np.int64)
        n_segs = int(seg_cnt.sum())
        seg_list = np.repeat(np.arange(len(sizes)), seg_cnt)
        seg_valid = np.clip(sizes[seg_list] - (np.arange(n_segs) - seg_start[seg_list]) * seg,
                            0, seg).astype(np.int32)
        return cls(sizes, seg_cnt, seg_start, seg_valid, seg)


class SeededCodes:
    """Random uint8 codes [n_segs, *block], made on ``device`` block by
    block. Block ``b`` (``CODE_BLOCK_SEGS`` segments) is one generator
    call keyed by (seed, b), so a segment's bytes do not depend on the
    slice that reads it. Slicing returns a host numpy array (what an
    install streams from); ``segments`` returns device tensors."""

    dtype = np.dtype(np.uint8)

    def __init__(self, shape, seed: int, device):
        self.shape = tuple(shape)
        self.seed = seed
        self.device = torch.device(device)

    def block(self, b: int) -> torch.Tensor:
        lo = b * CODE_BLOCK_SEGS
        hi = min(lo + CODE_BLOCK_SEGS, self.shape[0])
        g = generator(self.seed, "codes", b, device=self.device)
        return torch.randint(0, 256, (hi - lo,) + self.shape[1:], dtype=torch.uint8,
                             device=self.device, generator=g)

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("seeded codes are read by slices of segments")
        lo, hi, step = key.indices(self.shape[0])
        if step != 1:
            raise TypeError("seeded codes are read by contiguous slices")
        parts = []
        for b in range(lo // CODE_BLOCK_SEGS, -(-hi // CODE_BLOCK_SEGS)):
            b0 = b * CODE_BLOCK_SEGS
            parts.append(self.block(b)[max(lo - b0, 0): hi - b0])
        if not parts:
            return np.zeros((0,) + self.shape[1:], np.uint8)
        return torch.cat(parts).cpu().numpy()

    def segments(self, segs: torch.Tensor) -> torch.Tensor:
        """The codes of segments ``segs`` [n] (any order, repeats allowed)
        as one device tensor [n, *block]; each block is made once."""
        segs = segs.to(self.device).long()
        out = torch.empty((len(segs),) + self.shape[1:], dtype=torch.uint8, device=self.device)
        blocks = segs // CODE_BLOCK_SEGS
        for b in torch.unique(blocks).tolist():
            sel = torch.nonzero(blocks == b).flatten()
            out[sel] = self.block(b)[segs[sel] - b * CODE_BLOCK_SEGS]
        return out


def row_ids(layout: Layout, seed: int, device) -> np.ndarray:
    """Corpus positions [n_segs, seg] int32 laid out list after list, a
    seeded permutation of 0..N-1, -1 in each list's padded tail."""
    n = int(layout.sizes.sum())
    seg = layout.seg
    size_t = torch.from_numpy(layout.sizes).to(device)
    dest = (torch.repeat_interleave(torch.from_numpy(layout.seg_start * seg).to(device), size_t,
                                    output_size=n)
            + torch.arange(n, device=device)
            - torch.repeat_interleave(torch.cumsum(size_t, 0) - size_t, size_t, output_size=n))
    rows = torch.full((layout.n_segs * seg,), -1, dtype=torch.int32, device=device)
    rows[dest] = torch.randperm(n, device=device,
                                generator=generator(seed, "row_ids", device=device)).int()
    del dest
    return rows.view(layout.n_segs, seg).cpu().numpy()


def trained_params(n_lists: int, dim: int, pq_m: int, ksub: int, seed: int, device):
    """(centroids [L, D], rotation [D, D], PQ codebooks [M, ksub, D/M]),
    f32 on ``device``: unit centroids, an orthogonal rotation, residual
    codebooks small beside the centroids (|r| ~ 0.3)."""
    g = generator(seed, "trained", device=device)
    cent = torch.nn.functional.normalize(
        torch.randn((n_lists, dim), device=device, generator=g), dim=1)
    rot, _ = torch.linalg.qr(torch.randn((dim, dim), device=device, generator=g))
    pqc = 0.01 * torch.randn((pq_m, ksub, dim // pq_m), device=device, generator=g)
    return cent, rot.contiguous(), pqc


def decode_codes(codes: torch.Tensor, pq_m: int) -> torch.Tensor:
    """Stored code bytes [n, MB] -> codes [n, M] int64 (4-bit codes are
    nibble-packed, the low nibble first)."""
    if codes.shape[1] * 2 == pq_m:
        return torch.stack([codes & 15, codes >> 4], dim=2).reshape(len(codes), pq_m).long()
    return codes.long()


def reconstructions(codes: SeededCodes, layout: Layout, rid: np.ndarray, cent, rot, pqc,
                    n: int, seed: int, noise: float = 0.0):
    """``n`` corpus rows decoded back to vectors (centroid + codewords,
    rotated back), plus ``noise`` times a unit Gaussian: queries near
    their own rows. -> (queries [n, D] f32 on the codes' device,
    positions [n] int64)."""
    r = rng(seed, "reconstructions")
    live = np.nonzero(layout.seg_valid)[0]
    segs = live[r.integers(0, len(live), n)]
    within = (r.random(n) * layout.seg_valid[segs]).astype(np.int64)
    lists = np.searchsorted(layout.seg_start, segs, side="right") - 1
    dev = codes.device
    seg_codes = codes.segments(torch.from_numpy(segs))            # [n, MB, SEG]
    raw = seg_codes[torch.arange(n, device=dev), :, torch.from_numpy(within).to(dev)]
    m = pqc.shape[0]
    c = decode_codes(raw, m)
    resid = pqc[torch.arange(m, device=dev)[None, :], c].reshape(n, -1)
    v = cent[torch.from_numpy(lists).to(dev)] + resid
    q = v @ rot.T
    if noise:
        g = generator(seed, "reconstruction_noise", device=dev)
        q = q + noise * torch.nn.functional.normalize(
            torch.randn(q.shape, device=dev, generator=g), dim=1)
    return q, np.asarray(rid[segs, within], np.int64)


# -- the flat shard and the fill's rows ---------------------------------------------


def unit_rows(n: int, dim: int, seed: int, device, dtype=torch.bfloat16,
              block: int = 1 << 18) -> torch.Tensor:
    """[n, dim] unit Gaussian rows in ``dtype`` on ``device``, made a
    block at a time so no f32 copy of the whole shard exists."""
    out = torch.empty((n, dim), dtype=dtype, device=device)
    g = generator(seed, "unit_rows", device=device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        x = torch.randn((hi - lo, dim), device=device, generator=g)
        out[lo:hi] = torch.nn.functional.normalize(x, dim=1).to(dtype)
    return out


def fill_rows(n: int, group: int, cent, rot, weights: np.ndarray, seed: int,
              spread: float = 0.5) -> list:
    """The fill's input: ``n`` rows as host f32 row groups of ``group``
    rows. Each row lies between two lists, as real embeddings lie among
    neighbouring centroids: a centroid drawn by ``weights``, plus a
    uniform share of a second one, plus Gaussian spread, rotated back.
    So some rows sit near a tie between two lists, as in a real fill.
    -> [(rows [g, D] f32 numpy, positions [g] int64)]."""
    dev = cent.device
    dim = cent.shape[1]
    g = generator(seed, "fill_rows", device=dev)
    p = torch.from_numpy(np.asarray(weights, np.float64) / np.sum(weights)).to(dev)
    out = []
    for lo in range(0, n, group):
        m = min(lo + group, n) - lo
        a, b = torch.multinomial(p, 2 * m, replacement=True, generator=g).view(2, m)
        share = torch.rand((m, 1), device=dev, generator=g)
        x = (cent[a] + share * cent[b]
             + spread / dim ** 0.5 * torch.randn((m, dim), device=dev, generator=g))
        out.append(((x @ rot.T).cpu().numpy(), np.arange(lo, lo + m, dtype=np.int64)))
    return out


# -- the encoder's weights and typed texts --------------------------------------------


def stella_shapes(enc: dict) -> list:
    """(name, shape, kind) of every tensor of stella_en_1.5B_v5 under the
    HF names (``backbone.`` the Qwen2 model, ``vector_linear`` the MRL
    head); kind is "weight", "bias" or "norm"."""
    h, inter = enc["hidden_size"], enc["intermediate_size"]
    hd = enc["head_dim"]
    qd, kvd = enc["num_attention_heads"] * hd, enc["num_key_value_heads"] * hd
    out = [("backbone.embed_tokens.weight", (enc["vocab_size"], h), "weight")]
    for i in range(enc["num_hidden_layers"]):
        p = f"backbone.layers.{i}."
        out += [(p + "input_layernorm.weight", (h,), "norm"),
                (p + "self_attn.q_proj.weight", (qd, h), "weight"),
                (p + "self_attn.q_proj.bias", (qd,), "bias"),
                (p + "self_attn.k_proj.weight", (kvd, h), "weight"),
                (p + "self_attn.k_proj.bias", (kvd,), "bias"),
                (p + "self_attn.v_proj.weight", (kvd, h), "weight"),
                (p + "self_attn.v_proj.bias", (kvd,), "bias"),
                (p + "self_attn.o_proj.weight", (h, qd), "weight"),
                (p + "post_attention_layernorm.weight", (h,), "norm"),
                (p + "mlp.gate_proj.weight", (inter, h), "weight"),
                (p + "mlp.up_proj.weight", (inter, h), "weight"),
                (p + "mlp.down_proj.weight", (h, inter), "weight")]
    out += [("backbone.norm.weight", (h,), "norm"),
            ("vector_linear.weight", (enc["mrl_dim"], h), "weight"),
            ("vector_linear.bias", (enc["mrl_dim"],), "bias")]
    return out


def stella_weights(enc: dict, seed: int, device, std: float = 0.02) -> dict:
    """Every tensor of the encoder, f32 on ``device``, from one generator
    call: weights and biases N(0, std), norm scales 1 + N(0, std). The
    tensors are views of one buffer."""
    shapes = stella_shapes(enc)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, std, generator=generator(seed, "stella", device=device))
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = int(np.prod(shape))
        t = flat[at: at + n].view(shape)
        if kind == "norm":
            t.add_(1.0)
        out[name] = t
        at += n
    return out


def vocabulary(n: int = 8192) -> list:
    """A fixed vocabulary of lowercase words, 3-10 letters."""
    r = np.random.default_rng(20_261_017)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(r.choice(letters, r.integers(3, 11))) for _ in range(n)]


def typed_texts(word_counts: np.ndarray, seed: int, vocab: list) -> list:
    """One text of ``word_counts[i]`` words per request, words drawn from
    ``vocab`` by the seed."""
    r = rng(seed, "typed_texts")
    idx = r.integers(0, len(vocab), int(np.sum(word_counts)))
    out, at = [], 0
    for c in np.asarray(word_counts).tolist():
        out.append(" ".join(vocab[j] for j in idx[at: at + c]))
        at += c
    return out
