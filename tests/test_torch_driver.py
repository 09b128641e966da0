"""The port's driver and CLI against the JAX package's, end to end on the
CPU (``--device cpu``), mirroring ``tests/test_pipeline_e2e.py``.

- ``astpu-torch all`` from scratch: every artifact, a recall above 0.5,
  the same ``ids.parquet`` as the JAX package; a re-run is a no-op. The
  fill, tune and train stage records the port keeps beside the index.
- ``astpu-torch sync`` on the JAX package's trained quantizer (copied in:
  train is order-only), beside the JAX driver's ``sync`` steps: equal
  ``ids.parquet``, byte-equal filled lists, the same chosen nprobe and
  recall in ``params.json``, and ``from_artifacts`` returning the same
  ids. Then an incremental sync (equal delta sub-index), ``index
  compact`` (equal base again), ``recover``, ``publish`` and ``clean``.
- The two deliberate differences from the JAX copy, each shown refusing
  where the JAX copy admits: a crash inside ``_IdsWriter.commit`` leaves
  a tombstone that ``IdMap`` refuses; ``target_compact`` checks the
  filled index's ``meta.json``.
- The CLI: ``clean`` refuses ``--coordinator``, entry points default to the
  card, ``index clean`` needs no device, ``index resegment`` rewrites
  lists byte-equal to the JAX package's.
- The watchdog: beats on INFO records without changing what handlers
  print, fires on silence.
"""

import gzip
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from abstracts_search_tpu.config import Config as JaxConfig
from abstracts_search_tpu.driver import Driver as JaxDriver
from abstracts_search_tpu.driver import _IdsWriter as JaxIdsWriter
from abstracts_search_tpu.driver import _write_ids_parquet as jax_write_ids
from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
from abstracts_search_tpu.storage.idmap import IdMap as JaxIdMap
from abstracts_search_tpu_torch import cli
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.driver import Driver, _IdsWriter, _write_ids_parquet
from abstracts_search_tpu_torch.driver import read_ids_parquet
from abstracts_search_tpu_torch.serve.engine import SearchEngine
from abstracts_search_tpu_torch.storage.idmap import IdMap

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(embed_dim=32, ivf_centroids=4, pq_m=8, pq_nbits=4, train_sample=10_000,
           shard_size=64, row_group_size=16, embed_batch=8,
           # deltas stay until an explicit compact
           compact_max_delta_frac=10.0)
LIST_FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
              "lists_meta.json")
TEXTS = ["Study 17 topic3 research detail17", "Study 5 topic5 research detail5",
         "unrelated query text"]


def work(i, date):
    return {"id": f"https://openalex.org/W{date}x{i}", "title": f"Study {i}",
            "language": "en",
            "abstract_inverted_index": {f"topic{i % 7}": [0], "research": [1],
                                        f"detail{i}": [2]}}


def snapshot(root: Path, dates_counts) -> str:
    entries = []
    for date, n in dates_counts:
        pdir = root / "snapshot" / f"updated_date={date}"
        pdir.mkdir(parents=True, exist_ok=True)
        part = pdir / "part_000.gz"
        part.write_bytes(gzip.compress(
            ("\n".join(json.dumps(work(i, date)) for i in range(n)) + "\n").encode()))
        entries.append({"url": part.as_uri()})
    manifest = root / "manifest.json"
    manifest.write_text(json.dumps({"entries": entries}))
    return manifest.as_uri()


def astpu(cwd: Path, monkeypatch, *argv) -> int:
    monkeypatch.chdir(cwd)
    return cli.main(["--device", "cpu", *argv])


def port_tree(root: Path, url: str) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    (root / "env.json").write_text(json.dumps({**CFG, "manifest_url": url}))
    return root


def lists_bytes(d: Path) -> dict:
    return {f: (d / "lists" / f).read_bytes() for f in LIST_FILES}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's driver through build, dump, train, fill, tune,
    then an incremental sync's build + delta fill."""
    root = tmp_path_factory.mktemp("jax")
    url = snapshot(root, [("2024-01-01", 60)])
    d = JaxDriver(JaxConfig(manifest_url=url, **CFG), root=root, embedder="hash")
    d.target_build()
    d.target_dump()
    d.target_train()
    d.target_fill()
    d.target_tune()
    base = {"ids": read_ids_parquet(d.ids_path), "lists": lists_bytes(d.filled_dir),
            "params": json.loads(d.params_path.read_text())}
    engine = JaxEngine.from_artifacts(d.cfg, index_dir=d.index_dir, embedder="hash",
                                      hydrate=False)
    base["hits"] = [[r["id"] for r in row] for row in engine.search_batch(TEXTS, k=5)]
    url2 = snapshot(root, [("2024-01-01", 60), ("2024-04-01", 20)])
    d.cfg = d.cfg.replace(manifest_url=url2)
    d.target_build()
    assert d.incremental_ready()
    d.target_fill(incremental=True)
    delta = d.delta_dirs()[0]
    base["delta"] = {"ids": read_ids_parquet(delta / "ids.parquet"),
                     "lists": lists_bytes(delta / "index")}
    assert d.target_compact()
    base["compacted"] = {"ids": read_ids_parquet(d.ids_path),
                         "lists": lists_bytes(d.filled_dir)}
    return root, d, base


def test_cli_all_from_scratch(tmp_path, monkeypatch, jax_run):
    _, _, base = jax_run
    root = port_tree(tmp_path / "port", snapshot(tmp_path, [("2024-01-01", 60)]))
    assert astpu(root, monkeypatch, "all", "--embedder", "hash") == 0
    d = Driver(Config(manifest_url="file:///nowhere", **CFG), root=root, device="cpu")
    for p in (d.empty_dir / "meta.json", d.untuned_path, d.filled_dir / "lists" / "codes.bin",
              d.ids_path, d.params_path, d.index_dir / "build_report.json",
              d.index_dir / "tune_oracle.npz"):
        assert p.exists(), p
    assert read_ids_parquet(d.ids_path) == base["ids"]
    params = json.loads(d.params_path.read_text())
    assert params["achieved_recall"] > 0.5
    stamps = {p: p.stat().st_mtime_ns for p in (d.fill_stamp, d.params_path, d.ids_path)}
    assert astpu(root, monkeypatch, "all", "--embedder", "hash") == 0
    assert {p: p.stat().st_mtime_ns for p in stamps} == stamps


def test_fill_and_tune_write_stage_reports(tmp_path, monkeypatch):
    """A full fill and a tune record each stage's seconds and kernel
    launches beside the index; train records its steps in untuned.json.
    On the CPU every op takes its plain route, so no launch is counted."""
    root = port_tree(tmp_path / "port", snapshot(tmp_path, [("2024-01-01", 60)]))
    assert astpu(root, monkeypatch, "all", "--embedder", "hash") == 0
    d = Driver(Config(manifest_url="file:///nowhere", **CFG), root=root, device="cpu")
    fill = json.loads(d.fill_report_path.read_text())["stages"]
    tuned = json.loads(d.tune_report_path.read_text())["stages"]
    train = json.loads(d.untuned_path.read_text())["stages"]
    assert [s["stage"] for s in fill] == ["fill_stream", "save"]
    assert fill[0]["fill_stats"]["rows"] == len(read_ids_parquet(d.ids_path)) == 60
    assert [s["stage"] for s in tuned] == ["oracle", "sweep"]
    assert [s["stage"] for s in train] == (["opq"] if d.cfg.opq else []) + [
        "kmeans", "pq_residuals"]
    for s in fill + tuned + train:
        assert s["seconds"] >= 0 and s["launches"] == {}, s


def test_cli_sync_equals_jax(tmp_path, monkeypatch, jax_run):
    jroot, jd, base = jax_run
    url = snapshot(tmp_path, [("2024-01-01", 60)])
    root = port_tree(tmp_path / "port", url)
    d = Driver(Config(manifest_url=url, **CFG), root=root, device="cpu")
    # the JAX package's trained quantizer: train is order-only
    shutil.copytree(jd.empty_dir, d.empty_dir)
    shutil.copy(jd.untuned_path, d.untuned_path)
    assert astpu(root, monkeypatch, "sync", "--embedder", "hash") == 0
    assert read_ids_parquet(d.ids_path) == base["ids"]
    assert lists_bytes(d.filled_dir) == base["lists"]
    params = json.loads(d.params_path.read_text())
    assert (params["nprobe"], params["achieved_recall"]) == \
        (base["params"]["nprobe"], base["params"]["achieved_recall"])
    engine = SearchEngine.from_artifacts(d.cfg, index_dir=d.index_dir, embedder="hash",
                                         hydrate=False, device="cpu")
    assert [[r["id"] for r in row] for row in engine.search_batch(TEXTS, k=5)] == base["hits"]
    assert engine.search_batch(TEXTS[:1], k=5)[0][0]["id"].endswith("2024-01-01x17")

    # incremental sync: a new partition lands in a delta sub-index
    url2 = snapshot(tmp_path, [("2024-01-01", 60), ("2024-04-01", 20)])
    assert astpu(root, monkeypatch, "sync", "--incremental", "--manifest", url2,
                 "--embedder", "hash") == 0
    (delta,) = d.delta_dirs()
    assert read_ids_parquet(delta / "ids.parquet") == base["delta"]["ids"]
    assert lists_bytes(delta / "index") == base["delta"]["lists"]
    assert astpu(root, monkeypatch, "index", "compact") == 0
    assert not d.delta_dirs()
    assert read_ids_parquet(d.ids_path) == base["compacted"]["ids"]
    assert lists_bytes(d.filled_dir) == base["compacted"]["lists"]

    # publish stages a tree that recover bootstraps from
    out = tmp_path / "staged"
    assert astpu(root, monkeypatch, "publish", "--out", str(out)) == 0
    assert (out / "abstracts-faiss" / "index" / "index" / "lists" / "codes.bin").exists()
    assert (out / "abstracts-embeddings" / "events").is_dir()
    d.store_path.unlink()
    shutil.rmtree(d.events_dir)
    assert astpu(root, monkeypatch, "recover", "--embedder", "hash") == 0
    d.cfg = d.cfg.replace(manifest_url=url2)
    assert d.target_build() == {}                    # the sync position is restored
    assert astpu(root, monkeypatch, "clean") == 0
    assert not d.index_dir.exists() and not d.store_path.exists()


def test_ids_commit_crash_refused_where_jax_admits(tmp_path, monkeypatch):
    """A crash after the parquet rename and before the sidecar renames:
    the JAX copy leaves no meta, and the stale sidecar of the last commit
    is admitted by its probe; the port leaves a tombstone and refuses."""
    ids = [f"https://openalex.org/W{i}" for i in range(40)]
    real = Path.replace

    def crash_at_bin(self, target):
        if self.name.endswith(".tmp.bin"):
            raise OSError("crash inside the commit")
        return real(self, target)

    for name, write, writer, idmap in (("jax", jax_write_ids, JaxIdsWriter, JaxIdMap),
                                       ("port", _write_ids_parquet, _IdsWriter, IdMap)):
        dst = tmp_path / name / "ids.parquet"
        write(dst, ids)
        assert idmap(dst).uses_sidecar
        w = writer(dst.with_name("ids.parquet.tmp"))
        w.write(ids)
        with monkeypatch.context() as m:
            m.setattr(Path, "replace", crash_at_bin)
            with pytest.raises(OSError, match="crash"):
                w.commit(dst)
        got = idmap(dst)
        assert got.uses_sidecar == (name == "jax"), name
        assert got.resolve(np.arange(40)) == ids


def compact_tree(tmp_path, empty_spherical: bool, filled_spherical: bool):
    offline = dict(manifest_url="file:///nowhere", **CFG)
    cfg = Config(**offline)
    idx = tmp_path / cfg.index_dir
    for sub, sph in (("empty", empty_spherical), ("index", filled_spherical)):
        (idx / sub).mkdir(parents=True)
        (idx / sub / "meta.json").write_text(json.dumps({"spherical": sph}))
    (idx / "delta" / "0000" / "index").mkdir(parents=True)
    (idx / "delta" / "0000" / "index" / "meta.json").write_text("{}")
    (idx / "delta" / "0000" / "stamp.json").write_text(json.dumps({"rows": 3}))
    return (Driver(cfg, root=tmp_path, device="cpu"),
            JaxDriver(JaxConfig(**offline), root=tmp_path, embedder="hash"))


def test_compact_checks_the_filled_meta(tmp_path):
    """A legacy (non-spherical) filled index under a spherical empty/:
    the port refuses with the remedy, the JAX copy passes its guard (and
    stops later, at the missing store). And the converse."""
    d, jd = compact_tree(tmp_path / "a", empty_spherical=True, filled_spherical=False)
    with pytest.raises(ValueError, match="compact unavailable"):
        d.target_compact()
    with pytest.raises(FileNotFoundError, match="no store"):
        jd.target_compact()
    d, jd = compact_tree(tmp_path / "b", empty_spherical=False, filled_spherical=True)
    with pytest.raises(FileNotFoundError, match="no store"):
        d.target_compact()
    with pytest.raises(ValueError, match="compact unavailable"):
        jd.target_compact()


def test_cli_refuses_multi_process(monkeypatch, tmp_path, capsys):
    assert astpu(tmp_path, monkeypatch, "--coordinator", "localhost:1234",
                 "--num-processes", "2", "clean") == 1
    assert "multi-GPU" in capsys.readouterr().err


def test_cli_defaults_to_the_card(monkeypatch, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["index", "train", str(tmp_path)]) == 1
    assert "CUDA" in capsys.readouterr().err
    # index clean touches no device
    idx = tmp_path / Config().index_dir
    idx.mkdir(parents=True)
    assert cli.main(["index", "clean"]) == 0 and not idx.exists()


def test_cli_resegment_equals_jax(tmp_path, monkeypatch, jax_run):
    from abstracts_search_tpu.cli import main as jax_main

    _, jd, _ = jax_run
    rel = Path(Config().index_dir) / "index"
    for name in ("j", "t"):
        shutil.copytree(jd.filled_dir, tmp_path / name / rel)
    monkeypatch.chdir(tmp_path / "j")
    assert jax_main(["index", "resegment", "--seg-size", "8"]) == 0
    assert astpu(tmp_path / "t", monkeypatch, "index", "resegment", "--seg-size", "8") == 0
    a, b = (tmp_path / n / rel for n in ("j", "t"))
    assert lists_bytes(a) == lists_bytes(b)
    assert json.loads((a / "meta.json").read_text()) == json.loads((b / "meta.json").read_text())
    assert astpu(tmp_path / "t", monkeypatch, "index", "resegment", "--seg-size", "8") == 0


def run_py(code: str):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=ROOT)


def test_watchdog_beats_on_info_records():
    r = run_py("""
import logging, time
from abstracts_search_tpu_torch.utils.watchdog import Watchdog

wd = Watchdog.for_benchmark("t", timeout_s=1.0)
log = logging.getLogger("abstracts_search_tpu_torch.test")
t0 = time.monotonic()
while time.monotonic() - t0 < 2.5:
    log.info("progress")
    time.sleep(0.25)
wd.stop()
print("SURVIVED")
""")
    assert r.returncode == 0 and "SURVIVED" in r.stdout, r.stdout + r.stderr
    assert "device unreachable" not in r.stdout


def test_watchdog_fires_when_silent():
    r = run_py("""
import time
from abstracts_search_tpu_torch.utils.watchdog import Watchdog

Watchdog.for_benchmark("t", timeout_s=0.5)
time.sleep(10)
print("SHOULD NOT GET HERE")
""")
    assert r.returncode == 3
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert "device unreachable" in rec["error"] and rec["benchmark"] == "t"


def test_watchdog_keeps_handler_output():
    import io
    import logging

    from abstracts_search_tpu_torch.utils.watchdog import Watchdog

    root = logging.getLogger()
    prev_handlers, prev_level = root.handlers[:], root.level
    stream = io.StringIO()
    user = logging.StreamHandler(stream)
    try:
        root.handlers[:] = [user]
        root.setLevel(logging.WARNING)
        wd = Watchdog(timeout_s=60.0).start().attach_to_logging()
        log = logging.getLogger("abstracts_search_tpu_torch.test_leak")
        log.info("beat record")
        assert wd._beat.is_set() and "beat record" not in stream.getvalue()
        log.warning("warn record")
        assert "warn record" in stream.getvalue()
        wd.stop()
        assert root.level == logging.WARNING and user.level == logging.NOTSET
        assert root.handlers == [user]
    finally:
        root.handlers[:] = prev_handlers
        root.setLevel(prev_level)
