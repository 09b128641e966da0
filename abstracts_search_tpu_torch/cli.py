"""``astpu-torch`` — the port's command line.

The port of the JAX package's ``astpu`` CLI: the reference's
``sidecar-search`` commands plus the Makefile driver targets, over the
same artifact layout::

  astpu-torch [--device cpu] init <db>
  ... | astpu-torch build [-b N] <db>           # stdin {"id","document"} JSONL
  astpu-torch dump [--shard-size N] [--row-group-size N] <src> <dst>  # by arg order
  astpu-torch index -B <dir> train [-N] [-c N] [--pq-m M] [--pq-nbits B] [--no-opq] <data>
  astpu-torch index -B <dir> tune [--k K] [--target-recall R] <data>
  astpu-torch index -B <dir> fill [--incremental] <data>
  astpu-torch index -B <dir> resegment --seg-size N
  astpu-torch index -B <dir> sidecar | compact
  astpu-torch index --source <data> clean [-B <dir>]
  astpu-torch all | sync | recover | clean        # driver targets
  astpu-torch publish [--out DIR]
  astpu-torch convert-model <ckpt_dir>
  astpu-torch search "query text" [-k N]
  astpu-torch serve [--port P]

Run as ``python -m abstracts_search_tpu_torch.cli``. Everything runs on
the CUDA card unless ``--device cpu`` asks for the plain-PyTorch route.

``serve``, ``search``, the build (``index train``, ``index fill``,
``index tune``), ``dump``, ``sync`` and ``all`` also run over a
``torch.distributed`` mesh, one process per rank, every rank given the
same command: ``--coordinator HOST:PORT --num-processes W --process-id
R`` on each (or torchrun's environment), ``--dist-backend nccl`` (the
default on the card: one rank per card) or ``gloo`` (ranks that share a
card; the default with ``--device cpu``). Rank ``R`` runs on
``--device`` (default ``cuda:<local rank>``): it serves the lists ``l %
W == R`` (rank 0 holds the HTTP server), trains on its block of the
sample, encodes its share of the fill, and ingests its own partitions;
rank 0 writes the artifacts (``driver.py``). Every other command runs
in one process and refuses the mesh.

Env (reference-compatible): SIDECARSEARCH_MODEL,
SIDECARSEARCH_TRUST_REMOTE_CODE, MODEL_NAME, PROMPT_NAME,
TRUST_REMOTE_CODE, plus ASTPU_* overrides (``config.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
from pathlib import Path

from .config import load_config

logger = logging.getLogger("astpu")

# the commands that run over a mesh, and the index subcommands among them
MESH_COMMANDS = ("serve", "search", "sync", "all", "dump", "index")
MESH_INDEX_COMMANDS = ("train", "fill", "tune")


def _driver(args, cfg):
    from .driver import Driver

    return Driver(cfg, embedder=getattr(args, "embedder", "auto"), device=args.device,
                  mesh=args.mesh)


# -- sidecar-style subcommands -------------------------------------------------


def cmd_init(args, cfg):
    from .storage.sqlite_store import init_store

    init_store(args.db).close()
    print(f"initialized {args.db}")


def cmd_build(args, cfg):
    """stdin JSONL {"id","document"} -> embed -> upsert."""
    from .models.registry import get_embedder
    from .storage.sqlite_store import EmbeddingStore

    embedder = get_embedder(args.embedder, cfg, device=args.device)
    store = EmbeddingStore(args.db)
    # one sync revision per build: rows this run upserts are "new since
    # the last fill" for `fill --incremental`'s watermark
    store.bump_rev()
    batch_ids, batch_docs, n = [], [], 0
    stream = open(args.input) if args.input else sys.stdin

    def flush():
        nonlocal n
        if batch_ids:
            store.upsert(batch_ids, embedder(batch_docs))
            n += len(batch_ids)
            batch_ids.clear()
            batch_docs.clear()

    try:
        for line in stream:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            batch_ids.append(rec["id"])
            batch_docs.append(rec["document"])
            if len(batch_ids) >= args.batch_size:
                flush()
        flush()
    finally:
        store.close()
        if args.input:
            stream.close()
    print(f"embedded+upserted {n} documents into {args.db}")


def cmd_dump(args, cfg):
    """Bidirectional sqlite <-> parquet; direction by argument order. Over
    a mesh rank 0 alone writes; the others wait for it."""
    from .parallel.mesh import process_barrier

    try:
        if args.mesh is None or args.mesh.rank == 0:
            _dump(args)
    finally:
        if args.mesh is not None:
            process_barrier(args.mesh)


def _dump(args) -> None:
    from .storage.shards import dump_store_to_shards, load_shards_to_store
    from .storage.sqlite_store import EmbeddingStore, init_store

    src, dst = Path(args.src), Path(args.dst)
    if src.is_dir():  # parquet -> sqlite (recover direction)
        store = init_store(dst) if not dst.exists() else EmbeddingStore(dst)
        n = load_shards_to_store(src, store)
        store.close()
        print(f"recovered {n} rows {src} -> {dst}")
    else:  # sqlite -> parquet
        store = EmbeddingStore(src)
        n = dump_store_to_shards(store, dst, shard_size=args.shard_size,
                                 row_group_size=args.row_group_size)
        store.close()
        print(f"dumped {n} rows {src} -> {dst}")


def _resegment(d, seg_size: int) -> None:
    """Rewrite the FILLED artifact at another segment size without
    re-encoding; a crash mid-swap is recovered on the next run (the
    backup is authoritative until meta matches the new layout)."""
    from .index.lists import resegment_lists

    src = d.filled_dir
    meta_path = src / "meta.json"
    lists_dir, old_dir, tmp = src / "lists", src / "lists.old", src / "lists.tmp"
    if old_dir.exists() and not lists_dir.exists():
        old_dir.rename(lists_dir)
        print("recovered lists/ from interrupted resegment backup")
    meta = json.loads(meta_path.read_text())
    lists_seg = json.loads((lists_dir / "lists_meta.json").read_text())["seg_size"]
    if lists_seg == seg_size:
        # lists already rewritten; finish the interrupted swap
        if meta["seg_size"] != seg_size:
            meta["seg_size"] = seg_size
            meta_path.write_text(json.dumps(meta, indent=2))
        if old_dir.exists():
            shutil.rmtree(old_dir)
        print(f"already at seg_size={seg_size}")
        return
    for p in (tmp, old_dir):
        if p.exists():
            shutil.rmtree(p)
    resegment_lists(lists_dir, tmp, seg_size)
    lists_dir.rename(old_dir)          # keep the source until done
    tmp.rename(lists_dir)
    meta["seg_size"] = seg_size
    meta_path.write_text(json.dumps(meta, indent=2))
    shutil.rmtree(old_dir)             # drop the backup last
    print(f"resegmented {src} to seg_size={seg_size}")


def cmd_index(args, cfg):
    cfg = cfg.replace(
        index_dir=args.build_dir or cfg.index_dir,
        data_dir=args.data if args.data else cfg.data_dir,
        ivf_centroids=args.centroids,
        pq_m=args.pq_m,
        pq_nbits=args.pq_nbits,
        normalize=True if args.normalize else None,
        opq=(not args.no_opq) if args.no_opq else None,
        train_sample=args.sample,
    )
    if args.index_cmd == "clean":
        # `--source <data>` also drops the build intermediates cached
        # next to that data dir (training-sample memmaps)
        targets = [Path(cfg.index_dir)]
        if args.data:
            targets.append(Path(args.data) / ".astpu_cache")
        for p in targets:
            if p.exists():
                shutil.rmtree(p)
        print("index artifacts removed")
        return
    d = _driver(args, cfg)
    if args.index_cmd == "train":
        d.target_train(force=args.force, kmeans_iters=args.iters)
        print(f"train artifacts in {d.empty_dir} + {d.untuned_path}")
    elif args.index_cmd == "tune":
        d.target_tune(force=args.force, k=args.k, target_recall=args.target_recall)
        print(f"params in {d.params_path}")
    elif args.index_cmd == "fill":
        d.target_fill(force=args.force, incremental=args.incremental)
        extra = (f" (+{len(d.delta_dirs())} delta sub-index(es))" if d.delta_dirs() else "")
        print(f"filled index in {d.filled_dir} + {d.ids_path}{extra}")
    elif args.index_cmd == "resegment":
        _resegment(d, args.seg_size)
    elif args.index_cmd == "sidecar":
        # backfill ids.bin/ids.off for artifacts filled before the sidecar
        from .storage.idmap import build_sidecar

        for t in [d.ids_path] + [dd / "ids.parquet" for dd in d.delta_dirs()]:
            if t.exists():
                b, _ = build_sidecar(t, force=args.force)
                print(f"sidecar ready: {b}")
    elif args.index_cmd == "compact":
        if d.target_compact():
            print(f"compacted into {d.filled_dir} (deltas folded)")
        else:
            print("no delta sub-indexes; nothing to compact")


# -- driver targets --------------------------------------------------------------


def cmd_all(args, cfg):
    _driver(args, cfg).target_all()


def cmd_sync(args, cfg):
    if args.manifest:
        cfg = cfg.replace(manifest_url=args.manifest)
    d = _driver(args, cfg)
    res = d.target_build()
    print(json.dumps({"ingested_partitions": res}))
    # incremental sync skips the full re-dump (at 207M rows an ~850 GB
    # parquet rewrite): the delta fill streams from the store. Without a
    # prior full dump + fill the fill takes the full path, which needs
    # fresh shards: dump then, as over a mesh, whose fill is a full one.
    if args.incremental and d.incremental_ready() and d.mesh.size == 1:
        d.target_fill(incremental=True)
    else:
        d.target_dump()
        d.target_fill(incremental=args.incremental)
    d.target_tune()


def cmd_recover(args, cfg):
    _driver(args, cfg).target_recover()


def cmd_clean(args, cfg):
    _driver(args, cfg).target_clean()


# -- query side ------------------------------------------------------------------


def cmd_publish(args, cfg):
    """Validate (and optionally stage) the publishable dataset layouts:
    ``abstracts-embeddings`` (parquet + events, the recovery source of
    ``recover``) and ``abstracts-faiss`` (the index artifacts). Stages a
    complete upload tree under ``--out`` (hardlinks where possible, a
    manifest of file sizes) and prints the ``hf upload`` invocations."""
    problems = []
    emb_root = Path(cfg.data_dir).parent
    if not Path(cfg.data_dir).is_dir() or not list(Path(cfg.data_dir).glob("data_*.parquet")):
        problems.append(f"no parquet shards under {cfg.data_dir}")
    if not (emb_root / "events").is_dir():
        problems.append(f"no events/ next to {cfg.data_dir} (run `astpu all` to dump)")
    idx_root = Path(cfg.index_dir)
    for artifact in ("index", "ids.parquet", "params.json"):
        if not (idx_root / artifact).exists():
            problems.append(f"missing index artifact {idx_root / artifact}")
    if problems:
        for p in problems:
            print(f"publish: NOT READY: {p}", file=sys.stderr)
        raise RuntimeError("artifact layout incomplete")

    # incremental syncs defer the full re-dump, so the parquet dataset
    # can lag the store: publishing it would ship stale embeddings
    from .storage.shards import DUMP_META

    dm = Path(cfg.data_dir) / DUMP_META
    if Path(cfg.store_path).exists() and dm.exists():
        from .storage.sqlite_store import EmbeddingStore

        with EmbeddingStore(cfg.store_path) as st:
            live = st.sync_rev
        dumped = json.loads(dm.read_text()).get("store_rev") or 0
        if live > dumped:
            print(f"publish: WARNING: store revision {live} is past the dumped revision "
                  f"{dumped} (incremental syncs since the last dump) — run `astpu dump "
                  f"{cfg.store_path} {cfg.data_dir}` first or the published embeddings "
                  f"will be stale", file=sys.stderr)

    emb_src, faiss_src = emb_root, idx_root.parent
    if args.out:
        out = Path(args.out)
        # the named artifact trees, explicitly: walking ``.parent`` would
        # swallow the working directory (the staging output included)
        emb_src = _stage_trees(out / "abstracts-embeddings",
                               {"data": Path(cfg.data_dir), "events": emb_root / "events"})
        faiss_src = _stage_trees(out / "abstracts-faiss", {idx_root.name: idx_root})
        print(f"staged {emb_src} and {faiss_src} (see publish_manifest.json)")
    print("# publish the embeddings dataset (CC0) — recovery source for `astpu recover`")
    print(f"hf upload {args.embeddings_repo} {emb_src} --repo-type dataset")
    print("# publish the trained index")
    print(f"hf upload {args.faiss_repo} {faiss_src} --repo-type dataset")


def _stage_trees(dst, parts):
    """Hardlink (else copy) each named ``parts[name]`` tree into
    ``dst/name``, plus one size manifest."""
    dst = Path(dst)
    if dst.exists():
        shutil.rmtree(dst)
    manifest = {}
    for name, src in parts.items():
        src = Path(src)
        for root, _dirs, files in os.walk(src):
            rel_root = Path(name) / Path(root).relative_to(src)
            (dst / rel_root).mkdir(parents=True, exist_ok=True)
            for f in files:
                s, d = Path(root) / f, dst / rel_root / f
                try:
                    os.link(s, d)
                except OSError:
                    shutil.copy2(s, d)
                manifest[str(rel_root / f)] = s.stat().st_size
    (dst / "publish_manifest.json").write_text(json.dumps(manifest, indent=2, sort_keys=True))
    return dst


def cmd_convert_model(args, cfg):
    """HF checkpoint -> the port's safetensors checkpoint (one-time; needs
    transformers on the converting machine)."""
    from .models.registry import convert_and_save

    if args.model:
        cfg = cfg.replace(model_name=args.model)
    if args.identity_head:
        cfg = cfg.replace(identity_head=True)
    report = convert_and_save(cfg, args.ckpt_dir, verify=args.verify)
    if report is not None:
        print(f"verified: min cosine {report['min_cosine']:.6f} over "
              f"{report['texts']} texts x 2 modes"
              + (" (+ prompt registry)" if report["prompt_checked"] else ""))
    print(f"converted {cfg.model_name} -> {args.ckpt_dir}")
    print(f"serve with ASTPU_CKPT={args.ckpt_dir}")


def cmd_search(args, cfg):
    from .serve.engine import SearchEngine

    engine = SearchEngine.from_artifacts(cfg, index_dir=cfg.index_dir, embedder=args.embedder,
                                         hydrate=not args.no_hydrate, device=args.device,
                                         mesh=args.mesh)
    if args.mesh is not None and args.mesh.rank != 0:
        engine.follow()
        return
    try:
        for r in engine.search(args.query, k=args.k):
            print(json.dumps(r))
    finally:
        engine.stop_followers()


def cmd_serve(args, cfg):
    from .serve.app import run_server, stop_on_signals

    run_server(cfg, host=args.host, port=args.port, embedder=args.embedder,
               device=args.device, mesh=args.mesh, micro_batch=not args.no_micro_batch,
               micro_batch_workers=args.micro_batch_workers, on_bound=stop_on_signals)


# -- parser ----------------------------------------------------------------------


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="astpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="device of the indexes, the encoder and virtual corpora "
                        "(default: the CUDA card; 'cpu' for the plain-PyTorch route)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="rank 0's rendezvous address: run serve, search, index "
                        "train|fill|tune, dump, sync or all over a torch.distributed "
                        "mesh, one process per rank")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks in the mesh (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator; default: $RANK)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="collectives backend (default: nccl on the card, one rank per "
                        "card; gloo for ranks that share a card, and with --device cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="create an empty embedding store")
    sp.add_argument("db")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("build", help="embed stdin JSONL into the store")
    sp.add_argument("db")
    sp.add_argument("-b", "--batch-size", type=int, default=32)
    sp.add_argument("--embedder", default="auto", choices=["auto", "stella", "hash"])
    sp.add_argument("--input", help="read from file instead of stdin")
    sp.set_defaults(fn=cmd_build)

    sp = sub.add_parser("dump", help="sqlite <-> parquet (direction by arg order)")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--shard-size", type=int, default=2_097_152)
    sp.add_argument("--row-group-size", type=int, default=65_536)
    sp.set_defaults(fn=cmd_dump)

    sp = sub.add_parser("index", help="index train/tune/fill/clean")
    sp.add_argument("-B", "--build-dir", help="index artifact directory")
    sp.add_argument("--source", dest="data", help="data dir (clean)")
    isub = sp.add_subparsers(dest="index_cmd", required=True)
    for name in ("train", "tune", "fill", "clean", "resegment", "compact", "sidecar"):
        ip = isub.add_parser(name)
        if name not in ("clean", "resegment", "compact", "sidecar"):
            ip.add_argument("data", nargs="?")
        if name in ("resegment", "compact", "sidecar"):
            if name == "resegment":
                ip.add_argument("--seg-size", type=int, required=True)
            ip.set_defaults(data=None)
        ip.add_argument("--force", action="store_true")
        ip.add_argument("--embedder", default="hash")
        if name == "fill":
            ip.add_argument("--incremental", action="store_true",
                            help="index only rows upserted since the last fill into a "
                                 "delta sub-index")
        else:
            ip.set_defaults(incremental=False)
        if name == "train":
            ip.add_argument("-N", "--normalize", action="store_true",
                            help="unit-sphere inner-product mode (without it the PQ "
                                 "index refuses: its ADC scan ranks by inner product; "
                                 "exact plain-L2 is IVFFlatIndex's)")
            ip.add_argument("-c", "--centroids", type=int, default=None)
            ip.add_argument("--pq-m", type=int, default=None)
            ip.add_argument("--pq-nbits", type=int, default=None)
            ip.add_argument("--no-opq", action="store_true")
            ip.add_argument("--sample", type=int, default=None)
            ip.add_argument("--iters", type=int, default=10)
        else:
            ip.set_defaults(normalize=False, centroids=None, pq_m=None, pq_nbits=None,
                            no_opq=False, sample=None, iters=10)
        if name == "tune":
            ip.add_argument("--k", type=int, default=10)
            ip.add_argument("--target-recall", type=float, default=0.95)
        else:
            ip.set_defaults(k=10, target_recall=0.95)
    sp.set_defaults(fn=cmd_index)

    for name, fn in (("all", cmd_all), ("recover", cmd_recover), ("clean", cmd_clean)):
        sp = sub.add_parser(name, help=f"driver target: {name}")
        sp.add_argument("--embedder", default="auto")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("sync", help="full quarterly sync (build->dump->fill->tune)")
    sp.add_argument("--manifest", help="manifest URL override (file:// ok)")
    sp.add_argument("--embedder", default="auto")
    sp.add_argument("--incremental", action="store_true",
                    help="fill only rows upserted since the last fill into a delta "
                         "sub-index (O(delta) sync)")
    sp.set_defaults(fn=cmd_sync)

    sp = sub.add_parser("publish", help="validate artifact layouts; print upload commands")
    sp.add_argument("--embeddings-repo", default="you/abstracts-embeddings")
    sp.add_argument("--faiss-repo", default="you/abstracts-faiss")
    sp.add_argument("--out", help="stage a complete upload tree here (hardlinks)")
    sp.set_defaults(fn=cmd_publish)

    sp = sub.add_parser("convert-model",
                        help="HF checkpoint -> the port's safetensors checkpoint")
    sp.add_argument("ckpt_dir")
    sp.add_argument("--model", help="HF model name/dir (default: configured model)")
    sp.add_argument("--identity-head", action="store_true",
                    help="allow an UNTRAINED identity MRL head when the checkpoint ships "
                         "none (embeddings will not match the published model)")
    sp.add_argument("--verify", action="store_true",
                    help="check port-vs-HF embedding parity before writing the checkpoint")
    sp.set_defaults(fn=cmd_convert_model)

    sp = sub.add_parser("search", help="one-shot query against the index")
    sp.add_argument("query")
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("--embedder", default="auto")
    sp.add_argument("--no-hydrate", action="store_true",
                    help="skip OpenAlex metadata hydration")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("serve", help="HTTP search service")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7860)
    sp.add_argument("--embedder", default="auto")
    sp.add_argument("--no-micro-batch", action="store_true",
                    help="disable the concurrent-request gather window")
    sp.add_argument("--micro-batch-workers", type=int, default=4,
                    help="concurrent gather/dispatch workers")
    sp.set_defaults(fn=cmd_serve)
    return p


def _join_mesh(args):
    """This process's rank of the mesh that ``--coordinator`` (or
    torchrun's environment) names, or None for a one-process run. Only
    ``MESH_COMMANDS`` (of ``index``, ``MESH_INDEX_COMMANDS``) run over a
    mesh; the rest are refused before any rank joins."""
    from .parallel.mesh import init_distributed

    torchrun = all(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if args.coordinator is None and not torchrun:
        if args.num_processes or args.process_id is not None or args.dist_backend:
            raise ValueError("--num-processes/--process-id/--dist-backend need "
                             "--coordinator HOST:PORT (or torchrun's environment)")
        return None
    index_cmd = getattr(args, "index_cmd", None)
    if args.cmd not in MESH_COMMANDS or (args.cmd == "index"
                                         and index_cmd not in MESH_INDEX_COMMANDS):
        name = args.cmd if args.cmd != "index" else f"index {index_cmd}"
        over = [c for c in MESH_COMMANDS if c != "index"] + [
            f"index {c}" for c in MESH_INDEX_COMMANDS]
        raise ValueError(f"astpu-torch {name} runs in one process: over a mesh the port runs "
                         f"{', '.join(over)}; the other commands' multi-GPU paths wait in "
                         f"ROADMAP.md's queue")
    mesh = init_distributed(args.coordinator, args.num_processes, args.process_id,
                            args.dist_backend, device=args.device)
    args.device = str(mesh.device)
    return mesh


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config()
    try:
        args.mesh = _join_mesh(args)
        args.fn(args, cfg)
    except (FileExistsError, FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"astpu: error: {e}", file=sys.stderr)
        return 1
    if args.mesh is not None:
        from .parallel.mesh import shutdown_distributed

        shutdown_distributed(args.mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
