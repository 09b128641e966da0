#!/usr/bin/env python3
"""Which dtype the encoder's tp all-reduce should sum bf16 partials in.

    JAX_PLATFORMS=cpu python3 tests/tp_allreduce_dtype.py [--tp 2] [--seed 0]

On the CPU at the tiny stella config: the JAX package's bf16 encoder on a
``(1, tp)`` mesh of CPU devices (weights TP-sharded by its
``stella_param_shardings``) is the reference; the port runs the same
weights at bf16 on ``tp`` gloo ranks (this script, ``--rank``), once with
the partials of ``o_proj``/``down_proj`` summed in f32 and cast once (the
port's rule, ``models/qwen2.py`` ``_tp_sum``), once summed in bf16, and
once in one process. Prints one JSON line: the max and mean absolute
difference of each from the JAX mesh's unit embeddings, over seeded
token batches. A reading, not a gate.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _inputs(seed: int, b: int = 16, t: int = 24, vocab: int = 128):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, t)).astype(np.int64)
    mask = np.ones((b, t), np.int64)
    for r in range(b):
        mask[r, rng.integers(1, t + 1):] = 0
    return ids, mask


def rank_main(rank: int, tp: int, port: int, d: Path) -> int:
    import numpy as np
    import torch

    from abstracts_search_tpu_torch.models import qwen2, stella
    from abstracts_search_tpu_torch.models.checkpoint import load_file
    from abstracts_search_tpu_torch.parallel import init_distributed, shutdown_distributed
    from abstracts_search_tpu_torch.parallel.mesh import all_reduce
    from abstracts_search_tpu_torch.parallel.sharding import shard_state_dict

    torch.set_num_threads(1)
    mesh = init_distributed(f"127.0.0.1:{port}", tp, rank, device="cpu", tp=tp)
    cfg = stella.StellaConfig(backbone=qwen2.Qwen2Config.tiny(dtype=torch.bfloat16),
                              mrl_dim=16)
    sd = shard_state_dict(load_file(d / "sd.safetensors"), mesh.tp_rank, tp, cfg)
    model = stella.StellaEncoder(cfg, device="cpu", tp=mesh.tp_view())
    model.load_state_dict(sd)
    batches = np.load(d / "inputs.npz")
    out = {}
    f32_sum = qwen2._tp_sum
    for mode in ("f32", "bf16"):
        qwen2._tp_sum = f32_sum if mode == "f32" else (
            lambda tp_mesh, partial: partial if tp_mesh is None else all_reduce(tp_mesh,
                                                                                partial))
        with torch.inference_mode():
            out[mode] = np.concatenate([
                model(torch.from_numpy(batches[f"ids{i}"]),
                      torch.from_numpy(batches[f"mask{i}"])).numpy()
                for i in range(len(batches.files) // 2)])
    qwen2._tp_sum = f32_sum
    if rank == 0:
        np.savez(d / "port.npz", **out)
    shutdown_distributed(mesh)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.tp, args.port, Path(args.dir))

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from abstracts_search_tpu.models import qwen2 as jq
    from abstracts_search_tpu.models import stella as js
    from abstracts_search_tpu.parallel import build_mesh
    from abstracts_search_tpu.parallel.sharding import stella_param_shardings
    from abstracts_search_tpu_torch.models import qwen2, stella
    from abstracts_search_tpu_torch.models.checkpoint import save_file
    from abstracts_search_tpu_torch.models.convert import params_from_jax

    jcfg = js.StellaConfig(backbone=jq.Qwen2Config.tiny(dtype=jnp.bfloat16), mrl_dim=16)
    model = js.StellaEncoder(jcfg)
    ids0, mask0 = _inputs(args.seed)
    params = model.init(jax.random.key(args.seed), jnp.asarray(ids0), jnp.asarray(mask0))
    rng = np.random.default_rng(args.seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "bias" else np.asarray(x, np.float32), params)
    mesh = build_mesh(jax.devices()[:args.tp], tp=args.tp)
    apply = jax.jit(model.apply)
    placed = jax.device_put(params, stella_param_shardings(params, mesh))
    batches = [_inputs(args.seed + 10 + i) for i in range(args.batches)]
    want = np.concatenate([np.asarray(apply(placed, jnp.asarray(i), jnp.asarray(m)))
                           for i, m in batches])
    sd = params_from_jax(params)
    tcfg = stella.StellaConfig(backbone=qwen2.Qwen2Config.tiny(dtype=torch.bfloat16),
                               mrl_dim=16)
    one = stella.StellaEncoder(tcfg, device="cpu")
    one.load_state_dict(sd)
    with torch.inference_mode():
        mine = np.concatenate([one(torch.from_numpy(i), torch.from_numpy(m)).numpy()
                               for i, m in batches])
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        save_file(d / "sd.safetensors", sd)
        np.savez(d / "inputs.npz", **{f"ids{i}": b[0] for i, b in enumerate(batches)},
                 **{f"mask{i}": b[1] for i, b in enumerate(batches)})
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--tp", str(args.tp), "--rank",
                                   str(r), "--port", str(port), "--dir", str(d)])
                 for r in range(args.tp)]
        if any(p.wait(timeout=300) for p in procs):
            raise SystemExit("a rank failed")
        port_out = dict(np.load(d / "port.npz"))

    def diff(a):
        e = np.abs(a - want)
        return {"max_abs": float(e.max()), "mean_abs": float(e.mean())}

    print(json.dumps({"device": "cpu", "tp": args.tp, "rows": len(want),
                      "vs_jax_tp_mesh": {"sum_in_f32": diff(port_out["f32"]),
                                         "sum_in_bf16": diff(port_out["bf16"]),
                                         "one_process": diff(mine)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
