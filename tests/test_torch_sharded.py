"""Port parity of the sharded search (vaq_tpu_torch/parallel/,
``ivf.ShardedIVF``, ``VAQIndex.shard``) against vaq_tpu/parallel/ on the CPU.

JAX runs on ``make_mesh`` over n of the 8 virtual CPU devices that
tests/conftest.py provides, the port on n CPU shards of a mesh whose devices
repeat (``make_mesh(devices=["cpu"] * n)``), n ∈ {1, 2, 8}, and both on the
("q", "db") = (2, 4) grid. Both sides get the same inputs (JAX's sharded
arrays' host values), so the answers agree: distances within 1e-5 relative
(``1e-5 + 2^(idx_bits − 23)`` where the codes tier's window scan, K1, packs
its scores: ROADMAP fault 1), ids up to ties at the k-th distance. The
Pallas paths run in interpret mode, the port's kernel wrappers their plain
versions. Then shard-count invariance (tests/test_sharded.py), the traps,
and adds and deletes after ``shard``; the two-process gloo run is in
tests/test_torch_multiprocess.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import vaq_tpu
from test_torch_ivf import converted
from test_torch_scan_decoded import assert_topk_match
from test_torch_vaq import jax_state
from vaq_tpu import ivf as jivf
from vaq_tpu import kmeans as jkmeans
from vaq_tpu import parallel as jpar
from vaq_tpu import pca as jpca
from vaq_tpu.parallel import dist_kmeans as jdk
from vaq_tpu_torch import ivf, kmeans, parallel
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.errors import ConfigError, DeviceError, ShapeError
from vaq_tpu_torch.ops import distances, scan_codes
from vaq_tpu_torch.parallel import dist_kmeans
from vaq_tpu_torch.parallel.mesh import make_mesh
from vaq_tpu_torch.parallel.multihost import initialize_distributed, pod_mesh

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,TI32m16"
MESHES = ["1", "2", "8", "2x4"]


def meshes(name):
    """(JAX mesh, port mesh, q_axis) for a mesh id."""
    if name == "2x4":
        return (jpar.make_mesh((2, 4), ("q", "db")),
                make_mesh((2, 4), ("q", "db"), ["cpu"] * 8), "q")
    n = int(name)
    return (jpar.make_mesh(devices=jax.devices()[:n]),
            make_mesh(devices=["cpu"] * n), None)


def jax_rows(jmesh, x, fill=0):
    """x padded to the db axis and placed P("db", None...)."""
    x = jnp.asarray(x)
    pad = (-x.shape[0]) % jmesh.shape["db"]
    x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1),
                constant_values=fill)
    return jax.device_put(
        x, NamedSharding(jmesh, P("db", *([None] * (x.ndim - 1)))))


def jax_cols(jmesh, x):
    """(D, n) x padded and placed P(None, "db")."""
    x = jnp.asarray(x)
    x = jnp.pad(x, ((0, 0), (0, (-x.shape[1]) % jmesh.shape["db"])))
    return jax.device_put(x, NamedSharding(jmesh, P(None, "db")))


def t(a, dtype=None):
    """A host copy of a JAX or numpy array as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a, dtype=dtype))


def k1_rtol(block_rows):
    return 1e-5 + 2.0 ** ((block_rows - 1).bit_length() - 23)


@pytest.fixture(scope="module")
def pair(sift_like):
    """(queries, JAX index with probe state and its tiers, port index on the
    same converted state)."""
    base, queries, _ = sift_like
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx, visit=0.5)
    jidx._ensure_decoded()
    jidx._ensure_decoded8()
    return queries[:16], jidx


def fresh_port(jidx):
    """A port index on the JAX index's state and probe buckets."""
    return converted(jidx)


def jax_qp(jidx, queries):
    return jpca.project(queries, jidx.eigvecs, jidx.total_dim)


# --- each sharded function against JAX's -----------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_exact_matches_jax(mesh):
    jmesh, tmesh, q_axis = meshes(mesh)
    rng = np.random.default_rng(3)
    db = rng.standard_normal((501, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d_j, i_j = jpar.sharded_exact_search(
        jdk.shard_rows_for(jmesh, jnp.asarray(db)), jnp.asarray(q), 7,
        jnp.int32(501), jmesh, q_axis=q_axis)
    d_t, i_t = parallel.sharded_exact_search(
        dist_kmeans.shard_rows_for(tmesh, db), torch.as_tensor(q), 7, 501,
        tmesh, q_axis=q_axis)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    # and the unsharded exact search
    d_1, i_1 = distances.exact_search(torch.as_tensor(q),
                                      torch.as_tensor(db), 7)
    assert torch.equal(i_t, i_1)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_adc_matches_jax(mesh):
    jmesh, tmesh, q_axis = meshes(mesh)
    rng = np.random.default_rng(1)
    n, m, c, nq, k = 997, 8, 16, 6, 10
    codes = rng.integers(0, c, size=(n, m)).astype(np.int32)
    luts = rng.random((nq, m, c)).astype(np.float32)
    d_j, i_j = jpar.sharded_adc_search(
        jpar.shard_codes(jnp.asarray(codes), jmesh), jnp.asarray(luts), k,
        jnp.int32(n), jmesh, block_rows=64, q_axis=q_axis)
    d_t, i_t = parallel.sharded_adc_search(
        parallel.shard_codes(torch.as_tensor(codes), tmesh),
        torch.as_tensor(luts), k, n, tmesh, block_rows=64, q_axis=q_axis)
    assert i_t.numpy().max() < n
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decoded_matches_jax(pair, mesh):
    queries, jidx = pair
    jmesh, tmesh, q_axis = meshes(mesh)
    n = jidx.n_rows
    qp = jax_qp(jidx, queries)
    d_j, i_j = jpar.sharded_decoded_search(
        jax_rows(jmesh, jidx.decoded),
        jax_rows(jmesh, jidx.decoded_norms, np.inf), qp, 10, jnp.int32(n),
        jmesh, exact=True, q_axis=q_axis)
    d_t, i_t = parallel.sharded_decoded_search(
        parallel.shard_codes(t(jidx.decoded), tmesh),
        dist_kmeans.shard_rows_for(tmesh, t(jidx.decoded_norms)), t(qp),
        10, n, tmesh, q_axis=q_axis)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decoded8_matches_jax(pair, mesh):
    """JAX shards the columns of its (D, n) int8 rows, the port the rows of
    the (n, D) transpose."""
    queries, jidx = pair
    jmesh, tmesh, q_axis = meshes(mesh)
    n = jidx.n_rows
    qp = jax_qp(jidx, queries)
    d_j, i_j = jpar.sharded_decoded8_search(
        jax_cols(jmesh, jidx.decoded8), jidx.decoded8_scales,
        jax_rows(jmesh, jidx.decoded8_norms, np.inf), qp, 10, jnp.int32(n),
        jmesh, exact=True, q_axis=q_axis)
    d_t, i_t = parallel.sharded_decoded8_search(
        parallel.shard_codes(t(np.asarray(jidx.decoded8).T), tmesh),
        t(jidx.decoded8_scales),
        dist_kmeans.shard_rows_for(tmesh, t(jidx.decoded8_norms)), t(qp),
        10, n, tmesh, q_axis=q_axis)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


@pytest.mark.parametrize("mesh,block_rows", [("1", 64), ("2", 32),
                                             ("8", 16), ("2x4", 16)])
def test_sharded_codes_matches_jax(pair, mesh, block_rows):
    """K1/K2 per shard (plain versions here, JAX's kernels interpreted)."""
    queries, jidx = pair
    jmesh, tmesh, q_axis = meshes(mesh)
    n = jidx.n_rows
    qp = jax_qp(jidx, queries)
    table_j, rows_j = jidx._codes_tier()
    d_j, i_j = jpar.sharded_codes_search(
        jax_cols(jmesh, jidx.codes), table_j, rows_j, qp, 5, jnp.int32(n),
        jmesh, block_rows=block_rows, interpret=True, q_axis=q_axis)
    d_t, i_t = parallel.sharded_codes_search(
        parallel.shard_codes(t(jidx.codes_rowmajor()), tmesh),
        scan_codes.build_decode_table(jidx.centroids, "cpu"),
        scan_codes.build_decode_rows(jidx.centroids, "cpu"), t(qp), 5, n,
        tmesh, block_rows=block_rows, q_axis=q_axis)
    assert (i_t >= 0).all() and (i_t < n).all()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=k1_rtol(block_rows))


@pytest.mark.parametrize("mesh", MESHES)
def test_lloyd_sharded_matches_jax(mesh):
    jmesh, tmesh, _ = meshes(mesh)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((643, 8)).astype(np.float32)
    c0 = jkmeans.init_subset(x, 16, seed=5)
    want = jdk.lloyd_sharded(jdk.shard_rows_for(jmesh, jnp.asarray(x)),
                             jnp.asarray(c0), jnp.int32(643), 5, jmesh)
    got = dist_kmeans.lloyd_sharded(dist_kmeans.shard_rows_for(tmesh, x),
                                    torch.as_tensor(c0), 643, 5, tmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the port's own one-device Lloyd: equal assignments
    ref = kmeans.lloyd(torch.as_tensor(x), torch.as_tensor(c0), 5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    xt = torch.as_tensor(x)
    assert torch.equal(kmeans.assign_clusters(xt, got),
                       kmeans.assign_clusters(xt, ref))


@pytest.fixture(scope="module")
def d96_index():
    """The d = 96 probe fixture of tests/test_sharded.py:319-331 (JAX stores
    these buckets transposed; the converted port state is row-major)."""
    rng = np.random.default_rng(6)
    base = (rng.standard_normal((4096, 96)) *
            np.linspace(3.0, 0.3, 96)[None, :]).astype(np.float32)
    queries = base[rng.choice(4096, 16, replace=False)] + \
        0.05 * rng.standard_normal((16, 96)).astype(np.float32)
    jidx = vaq_tpu.VAQIndex(
        vaq_tpu.parse_method_string("VAQ192m24min7max8var1,TI32m24"))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx, visit=1.0)
    assert jidx.ivf.state.transposed
    jidx._ensure_decoded()
    return queries, jidx


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("d,second_stage", [(128, False), (128, True),
                                            (96, True)])
def test_sharded_ivf_matches_jax(pair, d96_index, mesh, d, second_stage):
    """ShardedIVF on one converted state, with and without the distributed
    exact second stage (the row-sharded decoded tier as its source)."""
    queries, jidx = pair if d == 128 else d96_index
    jmesh, tmesh, q_axis = meshes(mesh)
    tidx = fresh_port(jidx)
    tiers = ("decoded", "ivf") if second_stage else ("ivf",)
    rescore = {}
    if second_stage:
        rescore = dict(rescore_rows=jax_rows(jmesh, jidx.decoded),
                       rescore_norms=jax_rows(jmesh, jidx.decoded_norms,
                                              np.inf))
    sj = jivf.ShardedIVF(jidx.ivf.state, jidx.ivf.visit, jmesh, q_axis,
                         **rescore)
    qp = jax_qp(jidx, queries)
    d_j, i_j = sj.search(qp, 10)
    tidx.shard(tmesh, q_axis=q_axis, tiers=tiers)
    st = tidx._sharded_ivf
    assert (st.rescore_rows is not None) == second_stage
    assert st.params(10, 16) == sj.params(10, 16)[:4]
    d_t, i_t = st.search(t(qp), 10)
    atol = 1e-5 * float((np.asarray(qp) ** 2).sum(axis=1).max())
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("mesh", MESHES)
def test_index_shard_matches_jax(pair, mesh):
    """VAQIndex.shard over every tier, then search_device per tier and the
    probe through search(), against JAX's sharded index (exact=True)."""
    queries, jidx0 = pair
    jmesh, tmesh, q_axis = meshes(mesh)
    jidx = copy.copy(jidx0)     # shard() sets the copy's mesh fields only
    jidx.shard(jmesh, q_axis=q_axis, tiers=("decoded", "decoded8", "codes",
                                             "ivf"))
    tidx = fresh_port(jidx0)
    tidx.shard(tmesh, q_axis=q_axis, tiers=("decoded", "decoded8", "codes",
                                            "ivf"))
    for backend in ("decoded", "decoded8", "codes"):
        d_j, i_j = jidx.search_device(jnp.asarray(queries), 5,
                                      backend=backend, exact=True)
        d_t, i_t = tidx.search_device(torch.as_tensor(queries), 5,
                                      backend=backend)
        shard_rows = -(-jidx.n_rows // jmesh.shape["db"])
        br = max(16, min(512, shard_rows // (64 * 5)))
        rtol = k1_rtol(1 << (br.bit_length() - 1)) if backend == "codes" \
            else 1e-5
        assert_topk_match(d_t, i_t, d_j, i_j, rtol=rtol)
    d_j, i_j = jidx.search(queries, 10, backend="ivf")
    d_t, i_t = tidx.search(queries, 10, backend="ivf")
    atol = 1e-5 * float((np.asarray(jax_qp(jidx, queries)) ** 2)
                        .sum(axis=1).max())
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("first,second", [("4", "2"), ("2", "8")])
def test_reshard_lays_every_tier_on_the_new_mesh(pair, first, second):
    """shard() on one mesh, then again on another with the codes tier only:
    the tiers of the first call are laid out again on the second mesh, so
    every tier answers as a port index sharded once on the second mesh and
    as JAX's index sharded on it (JAX's search refuses a tier left on an
    earlier mesh's devices), never over the first mesh's part of the
    rows."""
    queries, jidx0 = pair
    all_tiers = ("decoded", "decoded8", "codes", "ivf")
    _, tm1, _ = meshes(first)
    jm2, tm2, _ = meshes(second)
    jidx = copy.copy(jidx0)
    jidx.shard(jm2, tiers=all_tiers)
    tidx = fresh_port(jidx0)
    tidx.shard(tm1, tiers=all_tiers)
    tidx.shard(tm2, tiers=("codes",))
    once = fresh_port(jidx0).shard(tm2, tiers=all_tiers)
    assert tidx._mesh is tm2
    for rows in (tidx._sharded_decoded, tidx._sharded_decoded8,
                 tidx._sharded_codes):
        assert len(rows.parts[0]) == int(second)
    q = torch.as_tensor(queries)
    for backend in ("decoded", "decoded8", "codes"):
        d_j, i_j = jidx.search_device(jnp.asarray(queries), 5,
                                      backend=backend, exact=True)
        d_t, i_t = tidx.search_device(q, 5, backend=backend)
        d_o, i_o = once.search_device(q, 5, backend=backend)
        assert torch.equal(i_t, i_o) and torch.equal(d_t, d_o), backend
        br = tidx._codes_block_rows(5, tidx._sharded_codes.shard_rows)
        rtol = k1_rtol(br) if backend == "codes" else 1e-5
        assert_topk_match(d_t, i_t, d_j, i_j, rtol=rtol)
    d_t, i_t = tidx.search(queries, 10, backend="ivf")
    d_o, i_o = once.search(queries, 10, backend="ivf")
    np.testing.assert_array_equal(i_t, i_o)
    np.testing.assert_array_equal(d_t, d_o)


# --- shard-count invariance and the traps (tests/test_sharded.py) ----------

@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_shard_count_invariance(pair, n_shards):
    """The decoded tier and the probe at visit 1.0 give the unsharded
    answers at any shard count (here exactly: one CPU, the same GEMMs). The
    int8 tier rescores 2k candidates a shard where one device rescores 2k
    in all, so, as in tests/test_sharded.py, its top-1 agrees and its
    distances can only improve."""
    queries, jidx = pair
    tidx = fresh_port(jidx)
    tidx.ivf.visit = 1.0
    q = torch.as_tensor(queries)
    want = {b: tidx.search_device(q, 10, backend=b)
            for b in ("decoded", "decoded8")}
    want["ivf"] = tidx.search(queries, 10, backend="ivf")
    tidx.shard(make_mesh(devices=["cpu"] * n_shards),
               tiers=("decoded", "decoded8", "ivf"))
    d, i = tidx.search_device(q, 10, backend="decoded")
    assert torch.equal(i, want["decoded"][1])
    torch.testing.assert_close(d, want["decoded"][0], rtol=1e-6, atol=1e-6)
    d, i = tidx.search_device(q, 10, backend="decoded8")
    assert torch.equal(i[:, 0], want["decoded8"][1][:, 0])
    assert (d <= want["decoded8"][0] * (1 + 1e-6) + 1e-6).all()
    d, i = tidx.search(queries, 10, backend="ivf")
    np.testing.assert_array_equal(i, want["ivf"][1])


def test_sharded_missing_tier_and_ti_traps(pair):
    """A backend whose tier was not sharded raises instead of serving the
    unsharded tier; so does the probe without the 'ivf' tier, and sharding
    'ivf' before attach_ivf."""
    queries, jidx = pair
    tidx = fresh_port(jidx)
    tidx.shard(make_mesh(devices=["cpu"] * 2))          # decoded only
    q = torch.as_tensor(queries[:4])
    for backend in ("decoded8", "codes"):
        with pytest.raises(ConfigError, match="not\\s+included"):
            tidx.search_device(q, 5, backend=backend)
    with pytest.raises(ConfigError, match="'ivf'"):
        tidx.search(queries[:4], 5, backend="ivf")
    assert tidx.search_device(q, 5)[1].shape == (4, 5)
    bare = index_from_numpy(*jax_state(jidx), "cpu")
    with pytest.raises(ConfigError, match="attach_ivf"):
        bare.shard(make_mesh(devices=["cpu"] * 2), tiers=("ivf",))
    with pytest.raises(ConfigError, match="unknown shard tiers"):
        bare.shard(make_mesh(devices=["cpu"] * 2), tiers=("lut",))
    with pytest.raises(ShapeError):    # 4 queries over a q axis of 3
        parallel.sharded_exact_search(
            dist_kmeans.shard_rows_for(make_mesh((3, 1), ("q", "db"),
                                                 ["cpu"] * 3),
                                       torch.zeros(8, 4)),
            torch.zeros(4, 4), 2, 8,
            make_mesh((3, 1), ("q", "db"), ["cpu"] * 3), q_axis="q")


def test_delete_and_add_after_shard(pair):
    """Tombstones made after shard() reach every sharded tier (+inf norms,
    poisoned sharded buckets, the codes tier's id filter), as JAX's do; an
    add releases every sharded buffer."""
    queries, jidx = pair
    tidx = fresh_port(jidx)
    tidx.shard(make_mesh(devices=["cpu"] * 8),
               tiers=("decoded", "decoded8", "codes", "ivf"))
    q = torch.as_tensor(queries[:4])
    tops = {b: int(tidx.search_device(q, 5, backend=b)[1][0, 0])
            for b in ("decoded", "decoded8", "codes")}
    tops["ivf"] = int(tidx.search(queries[:4], 10, backend="ivf")[1][0, 0])
    victims = sorted(set(tops.values()))
    tidx.delete(victims)
    for b in ("decoded", "decoded8", "codes"):
        _, i = tidx.search_device(q, 5, backend=b)
        assert not np.isin(i.numpy(), victims).any(), b
    _, i = tidx.search(queries[:4], 10, backend="ivf")
    assert not np.isin(i, victims).any()
    # the poisoned slots are the unsharded state's, shard by shard
    sh = tidx._sharded_ivf.shards[0]
    ids = torch.cat([s.bucket_ids for s in sh])[:tidx.ivf.state.ncl]
    assert torch.equal(ids, tidx.ivf.state.bucket_ids)
    assert torch.equal(torch.cat([s.sizes for s in sh])[:tidx.ivf.state.ncl],
                       tidx.ivf.state.sizes)
    # the same deletes on an unsharded index give the same answers
    plain = fresh_port(jidx)
    plain.delete(victims)
    assert torch.equal(tidx.search_device(q, 5, backend="decoded")[1],
                       plain.search_device(q, 5, backend="decoded")[1])
    new = tidx.add(queries[:3])
    assert tidx._mesh is None and tidx._sharded_decoded is None
    assert tidx._sharded_codes is None and tidx._sharded_ivf is None
    assert tidx.search(queries[:3], 1, backend="decoded")[1][:, 0].tolist() \
        == new.tolist()


# --- meshes ------------------------------------------------------------------

def test_mesh_repeats_devices_and_shapes():
    m = make_mesh((2, 4), ("q", "db"), ["cpu"] * 8)
    assert m.shape == {"q": 2, "db": 4}
    assert m.rows("db").shape == (2, 4) and m.offset("db") == 0
    assert make_mesh(devices=["cpu"] * 3).shape == {"db": 3}
    with pytest.raises(ConfigError):
        make_mesh((4,), devices=["cpu"] * 3)
    with pytest.raises(ConfigError):
        make_mesh((2,), ("rows",), ["cpu"] * 2)


def test_mesh_and_pod_mesh_need_a_card_by_default(monkeypatch):
    """make_mesh() and pod_mesh() span the visible cards; without one they
    raise DeviceError, never fall back to the CPU. One process: pod_mesh is
    a flat "db" mesh over the given devices, as JAX's (test_sharded.py:
    test_pod_mesh_single_process); initialize_distributed is a no-op."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="devices="):
        make_mesh()
    with pytest.raises(DeviceError):
        pod_mesh()
    with pytest.raises(DeviceError):
        make_mesh(devices=["cuda:0"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    mesh, q_axis = pod_mesh(devices=["cpu"] * 8)
    assert q_axis is None and mesh.shape["db"] == 8


def test_sharded_ivf_params_match_jax_after_padding(pair):
    """3 shards do not divide the 32 clusters: padded clusters (far
    centroids, zero sizes, poison rows, ids −1) never answer."""
    queries, jidx = pair
    jmesh = jpar.make_mesh(devices=jax.devices()[:3])
    sj = jivf.ShardedIVF(jidx.ivf.state, 0.5, jmesh)
    tidx = fresh_port(jidx)
    st = ivf.ShardedIVF(tidx.ivf.state, 0.5, make_mesh(devices=["cpu"] * 3))
    assert st.ncl_local == sj.ncl_local == 11
    assert st.params(10, 16) == sj.params(10, 16)[:4]
    last = st.shards[0][2]
    assert (last.bucket_ids[-1] == -1).all() and int(last.sizes[-1]) == 0
    d_j, i_j = sj.search(jax_qp(jidx, queries), 10)
    d_t, i_t = st.search(t(jax_qp(jidx, queries)), 10)
    atol = 1e-5 * float((np.asarray(jax_qp(jidx, queries)) ** 2)
                        .sum(axis=1).max())
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=atol)
