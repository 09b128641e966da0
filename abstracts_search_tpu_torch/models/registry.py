"""Embedder registry: pick the embedding backend by name.

- ``stella`` : the stella encoder (models/stella.py) on the card. Weights
               come from the port's checkpoint (``encoder_meta.json`` +
               ``encoder.safetensors``, written by ``convert_and_save``)
               when ``cfg.ckpt_dir`` holds one, else straight from the
               local HF snapshot of ``cfg.model_name`` and its
               sentence-transformers ``2_Dense_<d>`` MRL head.
- ``hash``   : deterministic offline embedder (seeded Gaussian per text),
               bit-identical to the JAX package's. Offline runs and tests
               use it; every stage downstream of embedding runs for real.
- ``auto``   : stella, or the hash embedder with a warning when the
               weights are missing (no checkpoint, no snapshot, no MRL
               head). Any other failure, on the device or in the
               weights' shapes, propagates.

An embedder is ``texts -> np.ndarray [n, dim] float32`` with a
``queries(texts)`` variant that applies the query prompt.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device

logger = logging.getLogger(__name__)


class HashEmbedder:
    """Deterministic pseudo-embedder for offline runs and tests."""

    def __init__(self, dim: int):
        self.dim = dim

    def _one(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha1(text.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def __call__(self, texts) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def queries(self, texts) -> np.ndarray:
        # prompting is meaningless for a hash embedder; corpus == query space
        return self(texts)


ENCODER_META = "encoder_meta.json"
# the port's weights file beside ENCODER_META; the JAX package keeps an
# orbax tree under params/ instead
ENCODER_WEIGHTS = "encoder.safetensors"


class MRLHeadNotFound(RuntimeError):
    """No trained MRL projection head could be located for the checkpoint.

    stella ships the head as a separate sentence-transformers
    ``2_Dense_<d>`` module; silently substituting an identity truncation
    would produce wrong embeddings with no error, so absence is a hard
    failure unless ``identity_head`` is explicitly requested.
    """


def _snapshot_dir(model_name: str):
    """Resolve the local HF snapshot directory for ``model_name``.

    A local path is used as-is; otherwise the hub cache is consulted
    WITHOUT network, where ``huggingface_hub`` is installed. Returns None
    when unresolvable."""
    p = Path(model_name)
    if p.is_dir():
        return p
    try:
        from huggingface_hub import snapshot_download

        return Path(snapshot_download(model_name, local_files_only=True))
    except (ImportError, OSError, ValueError):      # not installed / not cached
        return None


def _load_dense_module(module_dir: Path):
    """Load a sentence-transformers Dense module (linear.weight/bias),
    from ``model.safetensors`` or ``pytorch_model.bin``."""
    from .checkpoint import load_file

    st = module_dir / "model.safetensors"
    if st.is_file():
        tensors = load_file(st)
    else:
        bin_path = module_dir / "pytorch_model.bin"
        if not bin_path.is_file():
            return None, None
        tensors = torch.load(bin_path, map_location="cpu", weights_only=True)
    w = tensors.get("linear.weight")
    if w is None:
        raise MRLHeadNotFound(
            f"{module_dir} exists but has no 'linear.weight' "
            f"(keys: {sorted(tensors)})"
        )
    return w, tensors.get("linear.bias")


def _load_mrl_head(cfg: Config, sd):
    """Locate the trained MRL head: (weight [d_out, d_in], bias|None).

    Tries, in order:
      1. ``vector_linear.{weight,bias}`` inside the model state dict;
      2. the sentence-transformers ``2_Dense_{embed_dim}`` module dir in
         the HF snapshot, also accepting a bare ``2_Dense`` dir whose
         output width matches;
      3. with ``cfg.identity_head`` ONLY: an identity truncation
         (returns (None, None)).
    Anything else raises MRLHeadNotFound.
    """
    w = sd.get("vector_linear.weight")
    if w is not None:
        return w, sd.get("vector_linear.bias")

    snap = _snapshot_dir(cfg.model_name)
    if snap is not None:
        for mod_dir in (snap / f"2_Dense_{cfg.embed_dim}", snap / "2_Dense"):
            if not mod_dir.is_dir():
                continue
            w, b = _load_dense_module(mod_dir)
            if w is None:
                continue
            if w.shape[0] != cfg.embed_dim:
                raise MRLHeadNotFound(
                    f"{mod_dir} projects to {w.shape[0]} dims, but "
                    f"embed_dim={cfg.embed_dim}; point ASTPU_EMBED_DIM at "
                    f"the matching 2_Dense_<d> module"
                )
            logger.info("MRL head loaded from %s", mod_dir)
            return w, b

    if cfg.identity_head:
        logger.warning(
            "identity_head=True: substituting an UNTRAINED identity-"
            "truncation MRL head — embeddings will NOT match the "
            "published %s vectors", cfg.model_name,
        )
        return None, None

    raise MRLHeadNotFound(
        f"no trained MRL head found for {cfg.model_name!r}: "
        f"'vector_linear.weight' absent from the model state dict and no "
        f"2_Dense_{cfg.embed_dim}/ (or 2_Dense/) sentence-transformers "
        f"module in the snapshot"
        + (f" at {snap}" if snap is not None else " (snapshot dir unresolvable)")
        + ". Re-download the full checkpoint, or pass --identity-head to "
        "knowingly use an untrained truncation head."
    )


def _backbone_config(hf: dict):
    """A HF ``config.json`` -> the port's Qwen2Config."""
    from .qwen2 import Qwen2Config

    return Qwen2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        rope_theta=hf.get("rope_theta", 10_000.0),      # HF Qwen2Config's defaults
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
    )


def _convert_from_torch(cfg: Config, *, return_hf: bool = False):
    """The local HF snapshot -> (StellaConfig, state dict), read directly:
    ``config.json`` by json, the weights by the port's safetensors reader
    (models/checkpoint.py), so neither transformers nor a card is needed.

    ``return_hf=True`` additionally returns a live HF model (transformers,
    imported here; the CPU verification oracle of ``verify_conversion``)
    and the raw head tensors."""
    from .checkpoint import load_hf_weights
    from .convert import stella_state_dict
    from .stella import StellaConfig

    snap = _snapshot_dir(cfg.model_name)
    if snap is None or not (snap / "config.json").is_file():
        raise FileNotFoundError(
            f"no local snapshot with a config.json for {cfg.model_name!r}"
            + (f" (looked in {snap})" if snap is not None else ""))
    backbone = _backbone_config(json.loads((snap / "config.json").read_text()))
    sd = load_hf_weights(snap)
    scfg = StellaConfig(backbone=backbone, mrl_dim=cfg.embed_dim)
    dense_w, dense_b = _load_mrl_head(cfg, sd)
    if dense_w is None:  # identity_head escape hatch only
        dense_w = torch.eye(cfg.embed_dim, backbone.hidden_size)
        dense_b = None
    sd = {k: v for k, v in sd.items() if not k.startswith("vector_linear.")}
    params = stella_state_dict(sd, dense_w, dense_b)
    if return_hf:
        # the verification oracle is computed INDEPENDENTLY of the
        # converted state dict (one built from it would match its own
        # conversion bugs)
        from transformers import AutoModel

        model = AutoModel.from_pretrained(str(snap), trust_remote_code=cfg.trust_remote_code)
        return scfg, params, model, dense_w, dense_b
    return scfg, params


class ConversionVerificationError(RuntimeError):
    """Port/HF embedding (or prompt-registry) mismatch at convert time.

    The checkpoint is NOT written when this fires: serving a silently
    divergent encoder would search a different embedding space than the
    published corpus."""


# small, structurally diverse probe set: short/long, code-ish, unicode,
# repeated tokens — enough to catch transposed weights, wrong pooling,
# dropped biases, RoPE/mask bugs (any of which crater cosine on SOME of
# these even when others look fine)
VERIFY_TEXTS = [
    "The mitochondria is the powerhouse of the cell.",
    "A",
    "def topk(x, k):\n    return sorted(x)[-k:]  # O(n log n)",
    "Protein folding prediction advanced rapidly after 2020, with deep "
    "learning models reaching near-experimental accuracy on many targets "
    "and reshaping structural biology workflows across the field.",
    "naïve Bayes — ångström-scale 测量 of σ-bonds",
    "the the the the the the the the",
    "Quarterly OpenAlex snapshots add roughly two million new works.",
    "Hierarchical navigable small world graphs trade memory for recall.",
]


def verify_conversion(cfg: Config, scfg, params, hf_model,
                      dense_w, dense_b=None, *,
                      tokenizer=None, texts=None,
                      threshold: float = 0.999) -> dict:
    """First-run conversion gate, on the CPU.

    Compares the port's embeddings (the exact ``StellaEncoder`` serving
    forward on ``params``) against an oracle computed from the LIVE HF
    model and the RAW ``dense_w``/``dense_b`` MRL head — masked pooling,
    head projection, L2 normalization mirrored in numpy, all independent
    of ``params`` — on ``texts`` both as documents and as prompted
    queries, and byte-compares the prompt registry against the snapshot's
    own ``config_sentence_transformers.json``. Raises
    ConversionVerificationError on any cosine < ``threshold`` or prompt
    drift; returns a report dict otherwise.
    """
    from .stella import PROMPTS, StellaEncoder

    texts = list(texts if texts is not None else VERIFY_TEXTS)
    if tokenizer is None:
        from . import embed

        tokenizer = embed.load_hf_tokenizer(cfg.model_name)

    # 1. prompt-registry byte check against the snapshot's own config
    report: dict = {"texts": len(texts), "prompt_checked": False}
    snap = _snapshot_dir(cfg.model_name)
    if snap is not None and (snap / "config_sentence_transformers.json").is_file():
        st_cfg = json.loads((snap / "config_sentence_transformers.json").read_text())
        published = (st_cfg.get("prompts") or {}).get(cfg.query_prompt)
        if published is not None:
            ours = PROMPTS.get(cfg.query_prompt)
            if ours is None or published.encode() != ours.encode():
                raise ConversionVerificationError(
                    f"prompt registry drift for {cfg.query_prompt!r}: "
                    f"checkpoint publishes {published!r}, framework uses "
                    f"{ours!r} — query embeddings would diverge")
            report["prompt_checked"] = True

    # 2. port-vs-HF embedding parity, documents AND prompted queries. Head
    # from the RAW tensors ([mrl, hidden]) — never from ``params``.
    w = np.asarray(torch.as_tensor(dense_w).detach().float().cpu()).T   # [hidden, mrl]
    b = (np.asarray(torch.as_tensor(dense_b).detach().float().cpu())
         if dense_b is not None else 0.0)
    enc = StellaEncoder(scfg, device="cpu")
    enc.load_state_dict(params)
    enc.eval()
    hf_model.eval()
    worst = 1.0
    for prompt in (None, cfg.query_prompt):
        prefix = PROMPTS[prompt] if prompt else ""
        toks = [list(tokenizer(prefix + t)) for t in texts]
        T = max(len(t) for t in toks)
        ids = np.zeros((len(toks), T), np.int64)
        mask = np.zeros((len(toks), T), np.int64)
        for i, t in enumerate(toks):
            ids[i, : len(t)] = t
            mask[i, : len(t)] = 1
        with torch.inference_mode():
            hidden = hf_model(
                input_ids=torch.from_numpy(ids),
                attention_mask=torch.from_numpy(mask),
            ).last_hidden_state.float().numpy()
            got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        m = mask.astype(np.float32)[:, :, None]
        if scfg.pooling == "mean":
            pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1.0)
        elif scfg.pooling == "last":
            idx = np.maximum(mask.sum(1) - 1, 0)
            pooled = hidden[np.arange(len(toks)), idx]
        else:  # cls
            pooled = hidden[:, 0]
        ref = pooled @ w + b
        if scfg.normalize:
            ref = ref / np.maximum(np.linalg.norm(ref, axis=-1, keepdims=True), 1e-12)

        cos = np.sum(got * ref, axis=-1) / np.maximum(
            np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1), 1e-12)
        worst = min(worst, float(cos.min()))
        report[f"min_cosine_{'query' if prompt else 'document'}"] = float(cos.min())
        if cos.min() < threshold:
            bad = int(np.argmin(cos))
            raise ConversionVerificationError(
                f"port/HF embedding mismatch ({'query' if prompt else 'document'}"
                f" mode): cosine {cos.min():.6f} < {threshold} on text "
                f"{bad} ({texts[bad][:60]!r}) — conversion is wrong; the "
                f"checkpoint was NOT written")
    report["min_cosine"] = worst
    logger.info("conversion verified: min cosine %.6f over %d texts x 2 "
                "modes%s", worst, len(texts),
                " + prompt registry" if report["prompt_checked"] else "")
    return report


def _stella_config_to_json(scfg) -> dict:
    import dataclasses

    bb = {k: v for k, v in dataclasses.asdict(scfg.backbone).items()
          if k not in ("dtype", "param_dtype")}
    return {
        "backbone": bb,
        "mrl_dim": scfg.mrl_dim,
        "pooling": scfg.pooling,
        "causal": scfg.causal,
        "normalize": scfg.normalize,
    }


def _stella_config_from_json(d: dict):
    from .qwen2 import Qwen2Config
    from .stella import StellaConfig

    return StellaConfig(
        backbone=Qwen2Config(**d["backbone"]), mrl_dim=d["mrl_dim"],
        pooling=d["pooling"], causal=d["causal"], normalize=d["normalize"],
    )


def save_encoder(ckpt_dir, scfg, params: dict, model_name: str,
                 report: dict | None = None) -> None:
    """Write the port's encoder checkpoint: ``encoder_meta.json`` (the
    JAX package's schema) and the state dict as ``encoder.safetensors``."""
    from .checkpoint import save_file

    ckpt_dir = Path(ckpt_dir)
    save_file(ckpt_dir / ENCODER_WEIGHTS, params)
    meta = _stella_config_to_json(scfg)
    meta["model_name"] = model_name
    if report is not None:
        meta["verification"] = report
    (ckpt_dir / ENCODER_META).write_text(json.dumps(meta, indent=2))


def convert_and_save(cfg: Config, ckpt_dir, *, verify: bool = False) -> dict | None:
    """`astpu convert-model`: HF snapshot -> the port's checkpoint, once,
    so serving loads one safetensors file with no conversion.

    ``verify=True`` runs the first-run gate BEFORE anything is written:
    port-vs-HF embedding parity on VERIFY_TEXTS (documents + prompted
    queries, cosine >= 0.999) and the prompt-registry byte check
    (``verify_conversion``; needs transformers, on the CPU).
    """
    report = None
    if verify:
        scfg, params, model, dw, db = _convert_from_torch(cfg, return_hf=True)
        report = verify_conversion(cfg, scfg, params, model, dw, db)
        del model
    else:
        scfg, params = _convert_from_torch(cfg)
    save_encoder(ckpt_dir, scfg, params, cfg.model_name, report)
    logger.info("converted %s -> %s", cfg.model_name, ckpt_dir)
    return report


class StellaEmbedder:
    """Full stella pipeline: tokenize + the port's forward on ``device``
    (the card by default).

    Weights come from the port's checkpoint when ``cfg.ckpt_dir`` holds
    one (no conversion at load), else from the HF snapshot directly."""

    def __init__(self, cfg: Config, device=None):
        from . import embed
        from .checkpoint import load_file

        ckpt = Path(cfg.ckpt_dir) if cfg.ckpt_dir else None
        if ckpt is not None and (ckpt / ENCODER_META).is_file():
            weights = ckpt / ENCODER_WEIGHTS
            if not weights.is_file():
                raise FileNotFoundError(
                    f"{weights} is missing: the port loads its own safetensors "
                    f"checkpoint (an orbax params/ tree is the JAX package's); "
                    f"write it with the port's convert_and_save")
            device = resolve_device(device)
            scfg = _stella_config_from_json(json.loads((ckpt / ENCODER_META).read_text()))
            params = load_file(weights)
            logger.info("stella weights loaded from %s", weights)
        else:
            scfg, params = _convert_from_torch(cfg)
            device = resolve_device(device)
        self.pipeline = embed.EmbeddingPipeline(
            scfg, params, embed.load_hf_tokenizer(cfg.model_name),
            batch_size=cfg.embed_batch, device=device,
            # pow-2 batch buckets: a single interactive query encodes as
            # a 1-row forward instead of a full embed_batch-row one
            batch_buckets=True,
        )
        self.dim = cfg.embed_dim

    def __call__(self, texts) -> np.ndarray:
        return self.pipeline(texts)

    def queries(self, texts) -> np.ndarray:
        return self.pipeline.embed_queries(texts)


def get_embedder(name: str, cfg: Config, device=None, mesh=None):
    """The query encoder ``name`` ("hash", "stella" or "auto") on
    ``device``. Over a mesh with a process group only rank 0 encodes
    (the whole encoder, on its card) and broadcasts the query vectors:
    the other ranks get None. The build passes no mesh (``Driver``):
    every rank embeds its own partitions on its own card."""
    if mesh is not None and mesh.collective and mesh.rank != 0:
        return None
    if name == "hash":
        return HashEmbedder(cfg.embed_dim)
    if name == "stella":
        return StellaEmbedder(cfg, device=device)
    if name == "auto":
        try:
            return StellaEmbedder(cfg, device=device)
        except (MRLHeadNotFound, FileNotFoundError) as e:   # the weights are missing
            logger.warning("stella unavailable (%s); falling back to hash embedder", e)
            return HashEmbedder(cfg.embed_dim)
    raise ValueError(f"unknown embedder {name!r}")
