"""Each cell driven end to end at a tiny size on the CPU (the look for a
chip skipped): correct on sound runs, not correct with the timed path
broken underneath, and not correct with the control in the program's
place."""

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ["ivfpq_typed_steady", "flat_shard_k10", "ivfpq_vectors_np128", "ivfpq_fill_delta"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(name):
    out = tiny.run(name, seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    spec = harness.benchmark(parked=True)
    work, _, _ = tiny.cell(name)
    assert {m["name"] for m in harness.metrics_of(spec, work, False)} == set(out["metrics"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(name):
    out = tiny.run(name, seconds=1.5, trace=True)
    assert out["correct"], out["checks"]
    assert f"device_idle.{ {'ivfpq_typed_steady': 'typed', 'flat_shard_k10': 'flat', 'ivfpq_vectors_np128': 'vectors', 'ivfpq_fill_delta': 'fill'}[name] }" in out["metrics"]
    assert "breakdown" in out and out["device"]["window_s"] > 0


def _broken(name, fault):
    """A cell whose timed path is broken by ``fault`` once it is set up."""
    work, config, tr = tiny.cell(name)
    base = harness.driver(tr["driver"]).Cell

    class Broken(base):
        def setup(self):
            super().setup()
            fault(self)

    return Broken(config, tr, seed=7, device="cpu")


def _alter_top_answer(cell):
    """The index's answer altered where it is produced: each query's best
    position replaced by the next one."""
    idx = cell.index
    search = idx.search

    def wrong(q, k, **kw):
        v, p = search(q, k, **kw)
        p = p.copy()
        p[:, 0] = (p[:, 0] + 1) % idx.n
        return v, p

    idx.search = wrong


def _alter_token(cell):
    """A token altered where it is produced: the encoder's tokenizer
    gives each text's last token the next id."""
    pipe = cell.engine.embedder.pipeline
    tok = pipe.tokenizer
    vocab = cell.enc["vocab_size"]
    pipe.tokenizer = lambda text: tok(text)[:-1] + [(tok(text)[-1] + 1) % vocab]


def _drop_half(cell):
    """Half of each batch left out: the second half of the queries get
    no answer."""
    idx = cell.index
    search = idx.search

    def half(q, k, **kw):
        v, p = search(q, k, **kw)
        p, v = p.copy(), v.copy()
        p[len(p) // 2:] = -1
        return v, p

    idx.search = half


def _alter_flat(cell):
    search = cell.flat.search

    def wrong(q, k):
        v, p = search(q, k)
        p = p.copy()
        p[:, 0] = (p[:, 0] + 1) % cell.flat.n
        return v, p

    cell.flat.search = wrong


FAULTS = [
    ("ivfpq_typed_steady", _alter_top_answer),
    ("ivfpq_typed_steady", _alter_token),
    ("ivfpq_typed_steady", _drop_half),
    ("ivfpq_vectors_np128", _alter_top_answer),
    ("ivfpq_vectors_np128", _drop_half),
    ("flat_shard_k10", _alter_flat),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = tiny.run(name, seconds=1.0, cell_obj=_broken(name, fault))
    assert not out["correct"], out["checks"]


def _codes(monkeypatch):
    """The fill's codes altered where they are produced (every row)."""
    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

    enc = IVFPQIndex.encode
    monkeypatch.setattr(IVFPQIndex, "encode",
                        lambda self, v, **kw: (lambda a, c: (a, c ^ 1))(*enc(self, v, **kw)))


def _assign(monkeypatch):
    """The fill's assignments altered where they are produced."""
    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

    enc = IVFPQIndex.encode
    monkeypatch.setattr(IVFPQIndex, "encode", lambda self, v, **kw: (
        lambda a, c: ((a + 1) % self.n_lists, c))(*enc(self, v, **kw)))


def _pack(monkeypatch):
    """The pack writes two rows of a list out of stream order."""
    from abstracts_search_tpu_torch.index import ivfpq

    pack = ivfpq.pack_lists

    def swapped(*a, **kw):
        p = pack(*a, **kw)
        s = int(np.argmax(p.seg_valid >= 2))
        p.row_ids[s, [0, 1]] = p.row_ids[s, [1, 0]]
        p.data[s][:, [0, 1]] = p.data[s][:, [1, 0]]
        return p

    monkeypatch.setattr(ivfpq, "pack_lists", swapped)


@pytest.mark.parametrize("fault", [_codes, _assign, _pack], ids=lambda f: f.__name__)
def test_a_broken_fill_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run("ivfpq_fill_delta", seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    work, config, tr = tiny.cell(name)
    got = harness.driver(tr["driver"]).Cell(config, tr, seed=3, device="cpu").control(1.0)
    assert any(v > tr["limits"][k] for k, v in got.items()), got


def test_typed_cell_refuses_a_batcher_other_than_its_configuration():
    work, config, tr = tiny.cell("ivfpq_typed_steady")
    config["serve"] = dict(config["serve"], window_ms=2)
    cell = harness.driver(tr["driver"]).Cell(config, tr, seed=7, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="micro-batcher"):
            cell.setup()
    finally:
        cell.server.shutdown()
        cell.server.server_close()
