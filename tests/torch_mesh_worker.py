"""One rank of the port's corpus mesh, for tests/test_torch_parallel.py.

Launched as ``python torch_mesh_worker.py <rank> <world> <port> <job_dir>``:
joins a gloo group on the CPU (``tcp://127.0.0.1:<port>``), runs each
task of ``<job_dir>/job.json`` (every rank the same tasks, in order) and
writes its results to ``<job_dir>/out<rank>.npz``. It imports the port
and never JAX, as a rank of a deployment does.

Tasks (``kind``):
- ``merge``: ``merge_topk_all_gather`` of the rank's rows of ``values``
  and ``indices`` [W, Q, k_local] (an npz) at ``k``;
- ``ivfpq``: ``IVFPQIndex.load(art, mesh=)`` at ``storage`` (with
  ``hot_budget_bytes``), searched at each ``(k, nprobe)`` of ``cases``;
- ``ivf``: ``IVFFlatIndex.load(art, mesh=)``, the same cases;
- ``flat``: ``FlatIndex(mesh=)`` over the ``corpus`` npy, searched at ``k``;
- ``kmeans``: ``KMeans(mesh=)`` fit on the ``x`` npy (``mode``: an array,
  a staged tensor or a chunked device source of ``chunk_rows``), then
  ``assign`` of every row;
- ``pq`` / ``opq``: ``ProductQuantizer(mesh=)`` (host or staged rows) /
  ``OPQ(mesh=)`` trained on the ``x`` npy, with ``SCORE_BYTES`` at
  ``score_bytes`` (the window of rows a rank's block is made of);
- ``ivfpq_build``: ``IVFPQIndex(mesh=)`` trained on ``x``, the empty
  artifact saved by rank 0, reopened over the mesh and filled by
  ``fill_stream`` in chunks of ``chunk_rows`` (dealt round-robin) into
  ``filled/lists``,
  saved by rank 0, then searched at ``cases``;
- ``ivf_build``: ``IVFFlatIndex(mesh=)`` trained and filled on ``x``,
  searched at ``cases``;
- ``tune``: ``tune_index`` of the filled IVF-PQ artifact over the mesh
  against the ``x`` array oracle, with its cache;
- ``ingest``: ``Driver(mesh=)``: ``target_build`` of a ``file://``
  manifest with the hash embedder, then ``target_dump``;
- ``ivfpq_streamed``: ``IVFPQIndex(mesh=)`` trained on the ``x`` npy
  opened as a memmap (the streamed k-means mode, windows of
  ``window_rows``);
- ``driver_fill``: ``Driver(mesh=)``: ``target_train``, ``target_fill``
  and ``target_tune``, recording the parquet row groups each reads, then
  ``target_fill(incremental=True)``.

On a 2-D mesh (``job.json``'s ``tp``: ``init_distributed(tp=)``), with the
HF tokenizer's place taken by ``stable_tokenizer`` (crc32 of each word:
the same ids in every process, unlike the whitespace tokenizer's
``hash``):
- ``encode``: the stella encoder of the port checkpoint ``ckpt`` over the
  mesh: ``get_embedder("stella", mesh=)`` at f32, or an
  ``EmbeddingPipeline(mesh=)`` of the checkpoint's weights at ``dtype``
  bf16; ``forward`` of the ``ids``/``mask`` npz batch, documents and
  queries of ``texts``, ``_batch_pad`` at ``pads``, and this rank's state
  dict;
- ``engine_tp``: ``SearchEngine.from_artifacts(embedder="stella", mesh=)``
  over ``dir``: rank 0 sends two malformed requests (refused before any
  section), then searches ``texts`` in one batch and the first ``singles``
  one at a time and stops the followers; the others ``follow()``;
- ``embedder_choice``: ``get_embedder(embedder, mesh=)`` with the
  checkpoint ``ckpt`` on rank 0 and the directory ``empty`` (no weights)
  on the others; the class of what each rank raised;
- ``ingest_tp``: ``Driver(embedder="stella", mesh=)``: ``target_build``
  of a ``file://`` manifest, ``target_dump``, a second ``target_build``
  (its partitions, none on a re-run), then ``target_fill`` and
  ``target_tune`` (run over the shard axis by tp index 0's ranks).
"""

import dataclasses
import json
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stable_tokenizer(vocab_size: int):
    """The whitespace tokenizer's shape with crc32 in place of ``hash``."""
    def tok(text: str) -> list:
        return [zlib.crc32(w.encode()) % (vocab_size - 2) + 2 for w in text.split()] or [1]

    return tok


def main() -> int:
    rank, world, port, job_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  Path(sys.argv[4]))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.driver import Driver
    from abstracts_search_tpu_torch.index import FlatIndex, IVFFlatIndex, IVFPQIndex, tune
    from abstracts_search_tpu_torch.index.kmeans import KMeans
    from abstracts_search_tpu_torch.index.opq import OPQ
    from abstracts_search_tpu_torch.index.pq import ProductQuantizer
    from abstracts_search_tpu_torch.parallel import (deal, init_distributed,
                                                     merge_topk_all_gather, process_barrier,
                                                     shutdown_distributed)

    class Chunks:
        """A chunked device source over rows of ``x`` (CPU tensors)."""

        prenormalized = False

        def __init__(self, x, chunk_rows):
            self.x, self.chunk_rows = x, chunk_rows
            self.num_chunks, self.shape = len(x) // chunk_rows, x.shape

        def __len__(self):
            return len(self.x)

        def device_chunk(self, j):
            return torch.from_numpy(self.x[j * self.chunk_rows:(j + 1) * self.chunk_rows])

        def gather_rows(self, idx):
            return self.x[np.asarray(idx)]

    torch.set_num_threads(1)
    job = json.loads((job_dir / "job.json").read_text())
    mesh = init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                            timeout_s=job.get("timeout_s", 60), tp=job.get("tp", 1))
    out = {}
    for task in job["tasks"]:
        name, kind = task["name"], task["kind"]
        if kind == "merge":
            src = np.load(task["inputs"])
            v, i, st = merge_topk_all_gather(torch.from_numpy(src["values"][rank]),
                                             torch.from_numpy(src["indices"][rank]),
                                             task["k"], mesh, stats=torch.tensor([rank, 1]))
            out[f"{name}/v"], out[f"{name}/i"] = v.numpy(), i.numpy()
            out[f"{name}/stats"] = st.numpy()
        elif kind in ("ivfpq", "ivf"):
            q = np.load(task["queries"])
            if kind == "ivfpq":
                idx = IVFPQIndex.load(task["art"], mesh=mesh, chunk=task["chunk"],
                                      storage=task.get("storage", "device"),
                                      hot_budget_bytes=task.get("hot_budget_bytes", 1 << 30))
                out[f"{name}/resident_bytes"] = np.int64(idx.resident_bytes)
            else:
                idx = IVFFlatIndex.load(task["art"], mesh=mesh, chunk=task["chunk"])
            for k, nprobe in task["cases"]:
                v, p = idx.search(q, k, nprobe=nprobe)
                out[f"{name}/{k}_{nprobe}/v"], out[f"{name}/{k}_{nprobe}/p"] = v, p
            if kind == "ivfpq":
                st = idx.last_scan_stats
                out[f"{name}/live_slots_by_rank"] = np.asarray(st["live_slots_by_rank"])
                out[f"{name}/cold_live_slots"] = np.int64(st.get("cold_live_slots", 0))
        elif kind == "flat":
            flat = FlatIndex(chunk=task["chunk"], mesh=mesh)
            flat.add(np.load(task["corpus"]))
            out[f"{name}/v"], out[f"{name}/p"] = flat.search(np.load(task["queries"]),
                                                             task["k"])
            out[f"{name}/rows"] = np.int64(flat._rows)
        elif kind == "kmeans":
            x = np.load(task["x"])
            km = KMeans(task["k"], spherical=task["spherical"], chunk=task["chunk"],
                        seed=task["seed"], mesh=mesh)
            mode, kw = task["mode"], dict(iters=task["iters"])
            if mode == "array":
                km.fit(x, batch_rows=task["batch_rows"], **kw)
            elif mode == "staged":
                km.fit_staged(torch.from_numpy(x), batch_rows=task["batch_rows"], **kw)
            else:
                km.fit(Chunks(x, task["chunk_rows"]), batch_rows=task["batch_rows"], **kw)
            out[f"{name}/centroids"] = km.centroids
            for key in ("iters_run", "empty_splits", "objective", "reduce_bytes"):
                out[f"{name}/{key}"] = np.asarray(km.stats[key])
            out[f"{name}/assign"] = km.assign(x, batch_rows=task["batch_rows"])[1]
        elif kind == "pq":
            ProductQuantizer.SCORE_BYTES = task["score_bytes"]
            x = np.load(task["x"])
            pq = ProductQuantizer(x.shape[1], task["m"], task["nbits"], seed=task["seed"],
                                  mesh=mesh)
            if task["staged"]:
                pq.train_staged(torch.from_numpy(x.reshape(len(x), task["m"], -1)),
                                iters=task["iters"])
            else:
                pq.train(x, iters=task["iters"], batch_rows=task["batch_rows"])
            out[f"{name}/centroids"] = pq.centroids
        elif kind == "opq":
            ProductQuantizer.SCORE_BYTES = task["score_bytes"]
            x = np.load(task["x"])
            opq = OPQ(x.shape[1], task["m"], task["nbits"], seed=task["seed"], mesh=mesh)
            opq.train(x, outer_iters=task["outer"], pq_iters=task["pq_iters"])
            out[f"{name}/rotation"] = opq.rotation
            out[f"{name}/centroids"] = opq.pq.centroids
        elif kind == "ivfpq_build":
            x = np.load(task["x"])
            args = task["args"]
            idx = IVFPQIndex(task["n_lists"], x.shape[1], mesh=mesh, **args)
            idx.train(x, **task["train"])
            if rank == 0:
                idx.save(task["empty"], include_lists=False)
            process_barrier(mesh)
            for a in ("centroids", "pq_centroids", "rotation"):
                out[f"{name}/{a}"] = getattr(idx, a)
            out[f"{name}/kmeans_iters"] = np.int64(idx.train_stats["kmeans"]["iters_run"])
            idx = IVFPQIndex.load(task["empty"], mesh=mesh, chunk=args["chunk"])
            ch = task["chunk_rows"]
            idx.fill_stream(((x[i * ch:(i + 1) * ch], np.arange(i * ch, min(i * ch + ch, len(x))))
                             for i in deal(-(-len(x) // ch), mesh)),
                            lists_dir=Path(task["filled"]) / "lists")
            if rank == 0:
                idx.save(task["filled"])
            process_barrier(mesh)
            out[f"{name}/fill_rows"] = np.int64(idx.fill_stats["rank_rows"])
            q = np.load(task["queries"])
            for k, nprobe in task["cases"]:
                v, pos = idx.search(q, k, nprobe=nprobe)
                out[f"{name}/{k}_{nprobe}/v"], out[f"{name}/{k}_{nprobe}/p"] = v, pos
        elif kind == "ivfpq_streamed":
            IVFPQIndex.TRAIN_WINDOW_ROWS = task["window_rows"]
            x = np.load(task["x"], mmap_mode="r")
            idx = IVFPQIndex(task["n_lists"], x.shape[1], mesh=mesh, **task["args"])
            idx.train(x, workdir=job_dir / f"work{rank}", **task["train"])
            for a in ("centroids", "pq_centroids", "rotation"):
                out[f"{name}/{a}"] = getattr(idx, a)
            for a in ("train_mode", "rotated_rows"):
                out[f"{name}/{a}"] = np.asarray(idx.train_stats[a])
            out[f"{name}/kmeans_iters"] = np.int64(idx.train_stats["kmeans"]["iters_run"])
        elif kind == "ivf_build":
            x = np.load(task["x"])
            idx = IVFFlatIndex(task["n_lists"], seg_size=32, chunk=task["chunk"],
                               spherical=task["spherical"], seed=0, mesh=mesh)
            idx.train(x, iters=task["iters"])
            idx.fill(x)
            out[f"{name}/centroids"] = idx.centroids
            out[f"{name}/row_ids"] = np.asarray(idx.packed.row_ids)
            out[f"{name}/seg_cnt"] = np.asarray(idx.packed.seg_cnt)
            q = np.load(task["queries"])
            for k, nprobe in task["cases"]:
                v, pos = idx.search(q, k, nprobe=nprobe)
                out[f"{name}/{k}_{nprobe}/v"], out[f"{name}/{k}_{nprobe}/p"] = v, pos
        elif kind == "tune":
            idx = IVFPQIndex.load(task["art"], mesh=mesh, chunk=task["chunk"])
            key = {"fingerprint": {}, "n_queries": task["n_queries"], "k": task["k"],
                   "seed": 0, "spherical": True}
            params = tune.tune_index(idx, np.load(task["x"]), n_queries=task["n_queries"],
                                     k=task["k"], target_recall=task["target_recall"],
                                     timing_reps=1, oracle_cache=task["cache"],
                                     oracle_key=key)
            out[f"{name}/nprobe"] = np.int64(params["nprobe"])
            out[f"{name}/recall"] = np.asarray(
                [p["recall"] for p in params["operating_points"]])
        elif kind == "ingest":
            cfg = Config(**task["cfg"])
            d = Driver(cfg, root=task["root"], embedder="hash", device="cpu", mesh=mesh)
            res = d.target_build()
            out[f"{name}/partitions"] = np.asarray(sorted(res))
            out[f"{name}/dumped"] = np.int64(d.target_dump())
        elif kind == "driver_fill":
            cfg = Config(**task["cfg"])
            d = Driver(cfg, root=task["root"], embedder="hash", device="cpu", mesh=mesh)
            d.target_train(kmeans_iters=task["kmeans_iters"])
            # the parquet row groups this rank reads in the fill and in the
            # tune: "<target> <file> <row group> <columns>"
            reads, target = [], [None]
            init, read_row_group = pq.ParquetFile.__init__, pq.ParquetFile.read_row_group

            def named_init(self, source, *a, **kw):
                self.recorded_name = Path(source).name
                init(self, source, *a, **kw)

            def recorded_read(self, i, columns=None, **kw):
                reads.append(f"{target[0]} {getattr(self, 'recorded_name', '?')} {i} "
                             f"{','.join(columns or ['*'])}")
                return read_row_group(self, i, columns=columns, **kw)

            pq.ParquetFile.__init__, pq.ParquetFile.read_row_group = named_init, recorded_read
            try:
                target[0] = "fill"
                d.target_fill(kmeans_iters=task["kmeans_iters"])
                target[0] = "tune"
                d.target_tune(n_queries=task["n_queries"], k=task["k"])
            finally:
                pq.ParquetFile.__init__, pq.ParquetFile.read_row_group = init, read_row_group
            out[f"{name}/reads"] = np.asarray(reads)
            out[f"{name}/again"] = np.bool_(d.target_fill(incremental=True))
            params = json.loads(d.params_path.read_text())
            out[f"{name}/nprobe"] = np.int64(params["nprobe"])
            out[f"{name}/recall"] = np.float64(params["achieved_recall"])
            out[f"{name}/deltas"] = np.int64(len(d.delta_dirs()))
        elif kind == "embedder_choice":
            from abstracts_search_tpu_torch.models import embed
            from abstracts_search_tpu_torch.models.registry import get_embedder

            embed.load_hf_tokenizer = lambda model_name: stable_tokenizer(128)
            cfg = Config(ckpt_dir=task["ckpt"] if rank == 0 else task["empty"], embed_dim=16)
            try:
                get_embedder(task["embedder"], cfg, device="cpu", mesh=mesh)
                out[f"{name}/raised"] = np.asarray("")
            except Exception as e:  # noqa: BLE001 — the test reads which
                out[f"{name}/raised"] = np.asarray(type(e).__name__)
        elif kind in ("encode", "engine_tp", "ingest_tp"):
            out.update(stella_task(task, mesh, stable_tokenizer))
        else:
            raise ValueError(f"unknown task kind {kind!r}")
    np.savez(job_dir / f"out{rank}.npz", **out)
    shutdown_distributed(mesh)
    return 0


def stella_task(task: dict, mesh, tokenizer) -> dict:
    """The ``encode``, ``engine_tp`` and ``ingest_tp`` tasks (docstring)."""
    import numpy as np
    import torch

    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.driver import Driver
    from abstracts_search_tpu_torch.models import embed
    from abstracts_search_tpu_torch.models.checkpoint import load_file
    from abstracts_search_tpu_torch.models.registry import (ENCODER_META, ENCODER_WEIGHTS,
                                                            _stella_config_from_json,
                                                            get_embedder)
    from abstracts_search_tpu_torch.serve.engine import SearchEngine

    name, kind = task["name"], task["kind"]
    meta = json.loads((Path(task["ckpt"]) / ENCODER_META).read_text())
    vocab = meta["backbone"]["vocab_size"]
    embed.load_hf_tokenizer = lambda model_name: tokenizer(vocab)
    cfg = Config(ckpt_dir=task["ckpt"], **task.get("cfg", {}))
    out = {}
    if kind == "encode":
        if task.get("dtype", "f32") == "f32":
            pipe = get_embedder("stella", cfg, device="cpu", mesh=mesh).pipeline
        else:
            scfg = _stella_config_from_json(meta)
            scfg = dataclasses.replace(scfg, backbone=dataclasses.replace(
                scfg.backbone, dtype=torch.bfloat16))
            pipe = embed.EmbeddingPipeline(
                scfg, load_file(Path(task["ckpt"]) / ENCODER_WEIGHTS), tokenizer(vocab),
                batch_size=cfg.embed_batch, batch_buckets=True, mesh=mesh)
        batch = np.load(task["batch"])
        out[f"{name}/forward"] = pipe.forward(batch["ids"], batch["mask"])
        out[f"{name}/docs"] = pipe(task["texts"])
        out[f"{name}/queries"] = pipe.embed_queries(task["texts"])
        out[f"{name}/pads"] = np.asarray([pipe._batch_pad(n) for n in task["pads"]])
        for k, v in pipe.model.state_dict().items():
            out[f"{name}/sd/{k}"] = v.float().numpy()
    elif kind == "engine_tp":
        engine = SearchEngine.from_artifacts(cfg, index_dir=task["dir"], embedder="stella",
                                             hydrate=False, device="cpu", mesh=mesh)
        if mesh.rank == 0:
            refused = 0
            for bad in (lambda: engine.search_batch([1, 2]),
                        lambda: engine.search_batch(task["texts"], k=0)):
                try:
                    bad()
                except ValueError:
                    refused += 1
            out[f"{name}/refused"] = np.int64(refused)
            rows = engine.search_batch(task["texts"], 10)
            rows += [engine.search(t, 10) for t in task["texts"][:task["singles"]]]
            out[f"{name}/ids"] = np.asarray([[r["id"] for r in row] for row in rows])
            out[f"{name}/scores"] = np.asarray([[r["score"] for r in row] for row in rows])
            engine.stop_followers()
        else:
            engine.follow()
    else:
        d = Driver(cfg, root=task["root"], embedder="stella", device="cpu", mesh=mesh)
        out[f"{name}/partitions"] = np.asarray(sorted(d.target_build()))
        out[f"{name}/dumped"] = np.int64(d.target_dump())
        out[f"{name}/again"] = np.asarray(sorted(d.target_build()), dtype=str)
        out[f"{name}/filled"] = np.bool_(d.target_fill(kmeans_iters=task["kmeans_iters"]))
        out[f"{name}/tuned"] = np.bool_(d.target_tune(n_queries=task["n_queries"], k=3))
        out[f"{name}/nprobe"] = np.int64(json.loads(d.params_path.read_text())["nprobe"])
    return out


if __name__ == "__main__":
    sys.exit(main())
