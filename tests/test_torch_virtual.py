"""The port's virtual corpus against the JAX package's.

The device-side draws differ by design (a ``torch.Generator`` here,
``jax.random`` there), so the packages agree on what is drawn on the
host, bit for bit: spec validation, the mixture parameters, the sample
indices, the ``train_view`` chunk ids and the held-out queries' groups.
The port's own corpus is held to the planted structure (a core row's
exact top-``group_core`` set is its group's core rows; a held-out query's
too), determinism and the ShardReader protocol. The driver's data
fingerprint of a virtual dir is the JAX package's plus the generator
tag, and parquet and virtual sources of the same rows give equal index
quality through the port's driver (recall within 0.08, as the JAX
package's own differential test allows).
"""

import numpy as np
import pytest

from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.storage import virtual as jv
from abstracts_search_tpu_torch.storage import virtual as tv

SPEC = dict(n=4096, dim=64, d_int=16, n_clusters=32, group_size=8, group_core=5,
            group_noise=0.05, group_noise_outer=0.5, noise=0.5, seed=3, chunk_rows=512)
BAD_SPECS = [dict(n=1000, chunk_rows=512), dict(n=1024, chunk_rows=512, group_size=7),
             dict(n=1024, chunk_rows=512, group_core=0),
             dict(n=1024, chunk_rows=512, group_core=17),
             dict(n=1024, chunk_rows=512, center_scale=0.0),
             dict(n=1024, chunk_rows=512, query_noise=0.01),
             dict(n=1024, chunk_rows=512, query_noise=0.5)]


@pytest.fixture(scope="module")
def vdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vdata")
    tv.write_spec(d, tv.VirtualSpec(**SPEC))
    return d


@pytest.fixture(scope="module")
def reader(vdir):
    return tv.VirtualShardReader(vdir, device="cpu")


@pytest.fixture(scope="module")
def jreader(vdir):
    return jv.VirtualShardReader(vdir, mesh=build_mesh())


@pytest.fixture(scope="module")
def corpus(reader):
    return reader.read_all(with_ids=True)


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_validate_errors_equal_jax(kw):
    with pytest.raises(ValueError) as je:
        jv.VirtualSpec(**kw).validate()
    with pytest.raises(ValueError) as te:
        tv.VirtualSpec(**kw).validate()
    assert str(te.value) == str(je.value)


def test_spec_files_shared(tmp_path, vdir):
    assert (vdir / "virtual.json").read_text() == \
        jv.write_spec(tmp_path, jv.VirtualSpec(**SPEC)).read_text()
    assert tv.read_spec(tmp_path) == tv.VirtualSpec(**SPEC)
    assert isinstance(tv.open_data_source(vdir, device="cpu"), tv.VirtualShardReader)
    with pytest.raises(FileNotFoundError):
        tv.open_data_source(tmp_path / "nope", device="cpu")


def test_host_params_equal_jax(reader, jreader):
    for a, b in zip(reader._host_params(), jreader._host_params()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def capture_gather(r, monkeypatch):
    got = []
    monkeypatch.setattr(r, "gather_rows", lambda idx: got.append(np.asarray(idx)) or
                        np.zeros((len(idx), SPEC["dim"]), np.float32))
    return got


@pytest.mark.parametrize("n,seed", [(50, 1), (300, 0), (4096, 2)])
def test_sample_indices_equal_jax(reader, jreader, monkeypatch, n, seed):
    a, b = capture_gather(reader, monkeypatch), capture_gather(jreader, monkeypatch)
    reader.sample(n, seed=seed)
    jreader.sample(n, seed=seed)
    assert np.array_equal(a[0], b[0])


@pytest.mark.parametrize("n", [1, 500, 1500, 4096, 10_000])
def test_train_view_chunks_equal_jax(reader, jreader, n):
    v, jvw = reader.train_view(n), jreader.train_view(n)
    assert np.array_equal(v.chunk_ids, jvw.chunk_ids) and v.shape == jvw.shape


def test_chunks_deterministic_unit_and_distinct(reader):
    a, b = reader.device_chunk(2), reader.device_chunk(2)
    assert np.array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(np.linalg.norm(a.numpy(), axis=1), 1.0, atol=1e-5)
    assert not np.allclose(a.numpy(), reader.device_chunk(3).numpy())
    with pytest.raises(IndexError):
        reader.device_chunk(reader.num_chunks)


def test_reader_protocol(reader, corpus):
    ids, x = corpus
    assert len(reader) == SPEC["n"] == len(ids) == len(x) and reader.num_shards == 1
    assert ids[0] == "W0" and ids[-1] == f"W{SPEC['n'] - 1}"
    got = np.concatenate([e.numpy() for _, e in
                          reader.iter_row_groups(with_ids=False, start_row=1000)])
    np.testing.assert_array_equal(got, x[1000:])
    idx = np.random.default_rng(0).choice(SPEC["n"], size=97, replace=False)
    np.testing.assert_array_equal(reader.gather_rows(idx), x[idx])
    view = reader.train_view(1500)
    ch = SPEC["chunk_rows"]
    expect = np.concatenate([x[c * ch:(c + 1) * ch] for c in view.chunk_ids])
    np.testing.assert_array_equal(view.gather_rows(np.arange(7, 300, 13)), expect[7:300:13])
    np.testing.assert_array_equal(
        np.concatenate([view.device_chunk(j).numpy() for j in range(view.num_chunks)]), expect)


def test_planted_structure(corpus):
    _, x = corpus
    g, c = SPEC["group_size"], SPEC["group_core"]
    for grp in (0, 5, 17, 300, 511):
        top = np.argsort(-(x @ x[grp * g + 1]))     # a core row
        assert set(top[:c]) == set(range(grp * g, grp * g + c)), grp


def holdout_groups(q, x):
    """Each held-out query's group, from its exact top-``group_core``
    set, or -1 where that set is not one group's core rows."""
    g, c = SPEC["group_size"], SPEC["group_core"]
    out = []
    for s in q @ x.T:
        top = set(np.argsort(-s)[:c].tolist())
        grp = min(top) // g
        out.append(grp if top == set(range(grp * g, grp * g + c)) else -1)
    return np.array(out)


def test_holdout_groups_equal_jax(reader, jreader, corpus):
    """Both packages draw the same groups (numpy) and plant each query on
    its group's core set: the port's queries against the port's corpus,
    the JAX package's against its own."""
    q = reader.holdout_queries(24, seed=9)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    mine = holdout_groups(q, corpus[1])
    theirs = holdout_groups(jreader.holdout_queries(24, seed=9), jreader.read_all()[1])
    assert (mine >= 0).all() and np.array_equal(mine, theirs)
    assert np.array_equal(mine, np.sort(np.random.default_rng(9).choice(
        SPEC["n"] // SPEC["group_size"], size=24, replace=False)))
    assert np.array_equal(q, reader.holdout_queries(24, seed=9))


def driver_for(pkg, tmp_path, data_dir, **kw):
    cfg = pkg["Config"](data_dir=str(data_dir), index_dir=str(tmp_path / "idx"),
                        store_path=str(tmp_path / "data.sqlite"),
                        events_dir=str(tmp_path / "events"), embed_dim=SPEC["dim"], **kw)
    return pkg["Driver"](cfg, **pkg["kw"])


def packages():
    from abstracts_search_tpu.config import Config as JC
    from abstracts_search_tpu.driver import Driver as JD
    from abstracts_search_tpu_torch.config import Config as TC
    from abstracts_search_tpu_torch.driver import Driver as TD

    return ({"Config": JC, "Driver": JD, "kw": {}},
            {"Config": TC, "Driver": TD, "kw": {"device": "cpu"}})


def test_fingerprint_is_jax_plus_generator_tag(tmp_path, vdir):
    jax_pkg, port = packages()
    jfp = driver_for(jax_pkg, tmp_path / "j", vdir)._data_fingerprint()
    tfp = driver_for(port, tmp_path / "t", vdir)._data_fingerprint()
    tag = tfp.pop("generator")
    assert tfp == jfp and "virtual.json" in jfp
    assert tag == tv.generator_tag("cpu") != tv.generator_tag("cuda")
    assert tag.startswith("abstracts_search_tpu_torch/")


def test_driver_virtual_vs_parquet(tmp_path, vdir, corpus):
    """The port's driver trains, fills and tunes on a virtual dir and on
    parquet shards of the same rows, with equal index quality; re-runs
    are no-ops."""
    from abstracts_search_tpu_torch.index.tune import read_params
    from abstracts_search_tpu_torch.storage.shards import ShardWriter

    _, port = packages()
    ids, x = corpus
    pdir = tmp_path / "pdata"
    with ShardWriter(pdir, SPEC["dim"], shard_size=2048, row_group_size=512) as w:
        for lo in range(0, len(x), 512):
            w.write(ids[lo:lo + 512], x[lo:lo + 512])
    kw = dict(ivf_centroids=32, train_sample=2048, pq_m=16, pq_nbits=8, tune_sample=4096)
    dv = driver_for(port, tmp_path / "v", vdir, **kw)
    dp = driver_for(port, tmp_path / "p", pdir, **kw)
    for d in (dv, dp):
        assert d.target_train() and d.target_fill() and d.target_tune(n_queries=32, k=5)
    pv, pp = read_params(dv.params_path), read_params(dp.params_path)
    assert pv["achieved_recall"] >= 0.9 and pv["nprobe"] < 32, pv
    assert abs(pv["achieved_recall"] - pp["achieved_recall"]) < 0.08, (pv, pp)
    assert (dv.index_dir / "tune_oracle.npz").exists()
    assert not dv.target_fill() and not dv.target_tune()
    from abstracts_search_tpu_torch.driver import read_ids_parquet

    assert read_ids_parquet(dv.ids_path)[17] == "W17"
