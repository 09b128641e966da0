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
- ``flat``: ``FlatIndex(mesh=)`` over the ``corpus`` npy, searched at ``k``.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    rank, world, port, job_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  Path(sys.argv[4]))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from abstracts_search_tpu_torch.index import FlatIndex, IVFFlatIndex, IVFPQIndex
    from abstracts_search_tpu_torch.parallel import (init_distributed, merge_topk_all_gather,
                                                     shutdown_distributed)

    torch.set_num_threads(1)
    job = json.loads((job_dir / "job.json").read_text())
    mesh = init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60)
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
        else:
            raise ValueError(f"unknown task kind {kind!r}")
    np.savez(job_dir / f"out{rank}.npz", **out)
    shutdown_distributed(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
