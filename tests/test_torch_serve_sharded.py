"""``astpu-torch serve`` over a mesh of two CPU processes (gloo), as users
start it: ``--device cpu --coordinator 127.0.0.1:<port> --num-processes 2
--process-id R``.

The artifact directory holds a JAX-built base index (8 lists), one delta
sub-index (2 lists) whose ids supersede base works, ``ids.parquet`` and
``params.json``. Held here:

- ``POST /search`` on rank 0 returns the one-process engine's ids, and
  its scores exactly (each rank's sums are the one-process sums);
- SIGTERM to rank 0 stops the followers: both exit 0;
- a malformed request (k < 1, a k that is no integer) is refused on rank
  0 with a 400 and the mesh goes on serving; the engine itself refuses a
  malformed request before any collective, and refuses a delta swap;
- a killed follower fails rank 0 (its next request answers 500 and the
  process exits non-zero), and a killed rank 0 fails the follower, each
  within a minute (the collective timeout is 600 s);
- the build commands refuse the mesh before any rank joins.

POST does not hydrate, so no request leaves the machine.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch import cli
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.driver import _write_ids_parquet
from abstracts_search_tpu_torch.index.tune import write_params
from abstracts_search_tpu_torch.models.registry import HashEmbedder
from abstracts_search_tpu_torch.parallel import init_distributed, shutdown_distributed
from abstracts_search_tpu_torch.serve.engine import SearchEngine

ROOT = Path(__file__).resolve().parents[1]
DIM = 24
QUERIES = ["subject 3", "subject 7", "document number 11", "updated work 2",
           "something else entirely", "new work 4"]
# a lost rank shows as a closed connection at the next collective, long
# before the collective timeout (600 s)
FAIL_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ids(n, base=0):
    return [f"https://openalex.org/W{base + i}" for i in range(n)]


def _jax_index(x, n_lists):
    idx = JaxIVFPQ(n_lists, DIM, pq_m=4, pq_nbits=4, use_opq=False, mesh=build_mesh(),
                   seg_size=32, chunk=128, seed=0)
    idx.train(x, kmeans_iters=4, pq_iters=4)
    idx.fill(x)
    return idx


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_sharded")
    emb = HashEmbedder(DIM)
    docs = [f"document number {i} about subject {i % 13}" for i in range(400)]
    _jax_index(emb(docs), 8).save(root / "index")
    _write_ids_parquet(root / "ids.parquet", _ids(400))
    write_params(root / "params.json", {"nprobe": 3, "k": 10})
    ddocs = [f"updated work {i}" for i in range(20)] + \
        [f"new work {i} about subject {i % 5}" for i in range(20)]
    ddir = root / "delta" / "0001"
    _jax_index(np.concatenate([emb(ddocs)] * 8), 2).save(ddir / "index")
    _write_ids_parquet(ddir / "ids.parquet", (_ids(20) + _ids(20, base=400)) * 8)
    return root


@pytest.fixture(scope="module")
def want(art):
    cfg = Config(index_dir=str(art), embed_dim=DIM, index_storage="device")
    engine = SearchEngine.from_artifacts(cfg, index_dir=art, embedder="hash", hydrate=False,
                                         warmup=False, device="cpu")
    return engine.search_batch(QUERIES, k=10)


class Ranks:
    """``astpu-torch serve`` on two ranks; rank 0's HTTP port."""

    def __init__(self, art: Path, cwd: Path):
        self.http = _free_port()
        rdv = _free_port()
        env = {**os.environ, "ASTPU_INDEX_DIR": str(art), "ASTPU_EMBED_DIM": str(DIM),
               "ASTPU_INDEX_STORAGE": "device", "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        self.logs = [cwd / f"rank{r}.log" for r in range(2)]
        self.procs = [
            subprocess.Popen([sys.executable, "-m", "abstracts_search_tpu_torch.cli",
                              "--device", "cpu", "--coordinator", f"127.0.0.1:{rdv}",
                              "--num-processes", "2", "--process-id", str(r),
                              "serve", "--port", str(self.http), "--embedder", "hash"],
                             cwd=cwd, env=env, stdout=open(self.logs[r], "w"),
                             stderr=subprocess.STDOUT)
            for r in range(2)]

    def log(self, r: int) -> str:
        return self.logs[r].read_text()[-3000:]

    def wait_ready(self, timeout: float = 120) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for r, p in enumerate(self.procs):
                assert p.poll() is None, f"rank {r} exited {p.returncode}:\n{self.log(r)}"
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{self.http}/healthz",
                                            timeout=5) as resp:
                    if resp.status == 200:
                        return
            except OSError:
                time.sleep(0.2)
        raise AssertionError(f"rank 0 never served:\n{self.log(0)}")

    def post(self, queries, k=10):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.http}/search",
            data=json.dumps({"queries": queries, "k": k}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["results"]

    def get(self, query: str, k) -> list:
        url = f"http://127.0.0.1:{self.http}/search?" + urllib.parse.urlencode({"q": query, "k": k})
        with urllib.request.urlopen(url, timeout=60) as resp:
            return json.loads(resp.read())["results"]

    def wait(self, r: int, timeout: float) -> int:
        try:
            return self.procs[r].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"rank {r} still running after {timeout} s:\n"
                                 f"{self.log(r)}") from None

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture
def ranks(art, tmp_path):
    r = Ranks(art, tmp_path)
    yield r
    r.kill()


def test_serve_over_two_ranks_answers_as_one_process(ranks, want):
    ranks.wait_ready()
    for _ in range(2):                      # the second batch after a warm one
        got = ranks.post(QUERIES)
        assert [[r["id"] for r in row] for row in got] == \
            [[r["id"] for r in row] for row in want]
        assert [[r["score"] for r in row] for row in got] == \
            [[r["score"] for r in row] for row in want]
    ranks.procs[0].send_signal(signal.SIGTERM)
    assert ranks.wait(0, 60) == 0, ranks.log(0)
    assert ranks.wait(1, 60) == 0, ranks.log(1)


def test_a_malformed_request_leaves_the_mesh_serving(ranks, want):
    ranks.wait_ready()
    for send in (lambda: ranks.post(QUERIES, k=0), lambda: ranks.post(QUERIES, k=-1),
                 lambda: ranks.post(QUERIES, k="x"), lambda: ranks.get(QUERIES[0], -1),
                 lambda: ranks.get(QUERIES[0], 0)):
        with pytest.raises(urllib.error.HTTPError) as e:
            send()
        assert e.value.code == 400
    got = ranks.post(QUERIES)
    assert [[(r["id"], r["score"]) for r in row] for row in got] == \
        [[(r["id"], r["score"]) for r in row] for row in want]
    assert [r["id"] for r in ranks.get(QUERIES[0], 10)] == [r["id"] for r in want[0]]
    assert all(p.poll() is None for p in ranks.procs)


def test_the_engine_refuses_a_malformed_request_before_any_collective(art, want):
    cfg = Config(index_dir=str(art), embed_dim=DIM, index_storage="device")
    mesh = init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        engine = SearchEngine.from_artifacts(cfg, index_dir=art, embedder="hash",
                                             hydrate=False, warmup=False, device="cpu",
                                             mesh=mesh)
        q = engine.encode_queries(QUERIES)
        nan = q.copy()
        nan[1, 3] = np.nan
        for bad_q, k in ((q, 0), (q, -1), (q, 101), (q, 2.5), (q[:0], 10), (q[:, :-1], 10),
                         (nan, 10)):
            with pytest.raises(ValueError):
                engine.search_batch_encoded(bad_q, k=k)
        with pytest.raises(RuntimeError, match="fixed when it starts"):
            engine.deltas = []
        assert engine.failed is None
        got = engine.search_batch_encoded(q, k=10)
        assert [[(r["id"], r["score"]) for r in row] for row in got] == \
            [[(r["id"], r["score"]) for r in row] for row in want]
        engine.stop_followers()
    finally:
        shutdown_distributed(mesh)


def test_a_killed_follower_fails_rank_0(ranks, want):
    ranks.wait_ready()
    assert len(ranks.post(QUERIES[:2])) == 2
    ranks.procs[1].kill()
    ranks.procs[1].wait()
    t = time.monotonic()
    with pytest.raises(urllib.error.HTTPError) as e:
        ranks.post(QUERIES[:2])
    assert e.value.code == 500
    assert ranks.wait(0, FAIL_S) != 0
    assert time.monotonic() - t < FAIL_S
    assert "a rank of the mesh failed" in ranks.log(0)


def test_a_killed_rank_0_fails_the_follower(ranks):
    ranks.wait_ready()
    ranks.procs[0].kill()
    ranks.procs[0].wait()
    assert ranks.wait(1, FAIL_S) != 0


@pytest.mark.parametrize("argv", [["all"], ["index", "train"], ["sync"], ["build", "db"],
                                  ["dump", "a", "b"]])
def test_build_commands_refuse_the_mesh(argv, capsys):
    rc = cli.main(["--device", "cpu", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                   "--process-id", "0", *argv])
    assert rc == 1
    err = capsys.readouterr().err
    assert "runs in one process" in err and "slice 8" in err


def test_mesh_flags_need_a_coordinator(capsys):
    assert cli.main(["--device", "cpu", "--num-processes", "2", "serve"]) == 1
    assert "need --coordinator" in capsys.readouterr().err
