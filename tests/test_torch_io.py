"""Port parity of the dataset and artifact IO (vaq_tpu_torch/io.py, the
native host module vaq_tpu_torch/native/, and the index's reference-format
interop) against vaq_tpu on the CPU (tests/test_io.py, tests/test_native.py,
tests/test_vaq_e2e.py:159).

Readers and writers are numpy code copied from the JAX package, so they are
held to it exactly: the same arrays and dtypes from the same files, the same
bytes from the same arrays. The native module must agree with the numpy
paths it stands in for. An index exported by either package writes the same
bytes; one rebuilt from JAX-written artifacts adopts their codes and
centroids exactly and retrains its rotation, which then matches JAX's to the
f32 XᵀX tolerance (eigenvalues to rtol 1e-5 plus 1e-6 of the largest).
"""

import os

import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_crud import wide_state
from test_torch_scan_decoded import assert_topk_match
from test_torch_vaq import _jax_index, jax_state
from vaq_tpu import binary as jbinary
from vaq_tpu import io as jio
from vaq_tpu import native as jnative
from vaq_tpu_torch import io, native
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.errors import FormatError, NotReadyError

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,HEAP"


def no_native(monkeypatch, module):
    """Make ``module.get()`` find no extension: the numpy paths run."""
    monkeypatch.setattr(module, "_mod", None)
    monkeypatch.setattr(module, "_tried", True)


@pytest.fixture(scope="module")
def vec_files(tmp_path_factory):
    """fvecs, bvecs, ivecs, bin and ascii files written by the JAX
    package."""
    root = tmp_path_factory.mktemp("vecs")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 17)).astype(np.float32)
    ints = rng.integers(0, 1000, (40, 9)).astype(np.int32)
    paths = {ext: str(root / f"a{ext}") for ext in
             (".fvecs", ".ivecs", ".bvecs", ".bin", ".txt", ".csv")}
    jio.write_fvecs(paths[".fvecs"], x)
    jio.write_ivecs(paths[".ivecs"], ints)
    # a bvecs record: an int32 dim then dim bytes
    rec = np.concatenate([np.zeros((40, 4), np.uint8),
                          (ints % 256).astype(np.uint8)], axis=1)
    rec[:, :4] = np.frombuffer(np.int32(9).tobytes(), np.uint8)
    rec.tofile(paths[".bvecs"])
    x.tofile(paths[".bin"])
    np.savetxt(paths[".txt"], x[:6])
    np.savetxt(paths[".csv"], x[:6], delimiter=",")
    return paths, x, ints


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("max_rows", [None, 3])
def test_readers_match_jax(vec_files, monkeypatch, native_on, max_rows):
    paths, x, ints = vec_files
    if not native_on:
        no_native(monkeypatch, native)
    elif native.get() is None:
        pytest.skip("no compiler: the numpy paths are the case above")
    for fn in ("read_fvecs", "read_ivecs", "read_bvecs"):
        ext = "." + fn.split("_")[1]
        got = getattr(io, fn)(paths[ext], max_rows)
        want = getattr(jio, fn)(paths[ext], max_rows)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.read_fvecs(paths[".fvecs"], max_rows),
                                  x[:max_rows])
    for ext in (".fvecs", ".ivecs", ".bvecs", ".bin", ".txt", ".csv"):
        got = io.read_dataset(paths[ext], dim=17, max_rows=max_rows)
        want = jio.read_dataset(paths[ext], dim=17, max_rows=max_rows)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        io.read_bin(paths[".bin"], 17, max_rows=max_rows),
        jio.read_bin(paths[".bin"], 17, max_rows=max_rows))
    np.testing.assert_array_equal(io.read_ascii(paths[".csv"], ",", max_rows),
                                  jio.read_ascii(paths[".csv"], ",", max_rows))


@pytest.mark.parametrize("seed", [1, 13517106])
def test_sampled_readers_match_jax(vec_files, seed):
    paths, _, _ = vec_files
    for fn, args in (("read_fvecs_sampled", (paths[".fvecs"], 20)),
                     ("read_bvecs_sampled", (paths[".bvecs"], 20)),
                     ("read_bin_sampled", (paths[".bin"], 17, 20)),
                     ("read_vecs_sampled", (paths[".ivecs"], np.int32, 100))):
        got = getattr(io, fn)(*args, seed=seed)
        want = getattr(jio, fn)(*args, seed=seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native_on", [True, False])
def test_bad_files_raise_format_error(tmp_path, monkeypatch, native_on):
    if not native_on:
        no_native(monkeypatch, native)
    bad = tmp_path / "bad.fvecs"
    np.array([4, 1, 2], np.int32).tofile(bad)          # a cut record
    with pytest.raises(FormatError):
        io.read_fvecs(str(bad))
    np.array([-1, 0], np.int32).tofile(bad)            # a bad dimension
    with pytest.raises(FormatError):
        io.read_fvecs(str(bad))
    with pytest.raises(FormatError, match="extension"):
        io.read_dataset(str(tmp_path / "x.parquet"))
    with pytest.raises(FormatError, match="dim"):
        io.read_dataset(str(tmp_path / "x.bin"))


def _write_both(tmp_path, name, write):
    """Bytes of the file ``write(module, path)`` makes with each package."""
    out = []
    for tag, mod in (("port", io), ("jax", jio)):
        path = str(tmp_path / f"{tag}_{name}")
        write(mod, path)
        out.append(path)
    return out


def test_writers_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    labels = rng.integers(0, 10**6, (7, 4))
    dists = rng.random((7, 4)).astype(np.float32) * 100
    cents = [rng.standard_normal((2 ** (3 + i % 3), 4)).astype(np.float32)
             for i in range(5)]
    codes = rng.integers(0, 1 << 10, (30, 6)).astype(np.int32)
    writers = {
        "a.fvecs": lambda m, p: m.write_fvecs(p, x),
        "a.ivecs": lambda m, p: m.write_ivecs(p, labels),
        "res.csv": lambda m, p: m.write_knn_results(p, labels, dists),
        "res2.csv": lambda m, p: m.write_knn_results(p, labels),
        "cent.bin": lambda m, p: m.save_centroids_ref(p, cents),
        "codes.bin": lambda m, p: m.save_codebook_ref(p, codes),
        "bolt.csv": lambda m, p: m.write_centroids_bolt(p, cents),
    }
    for name, write in writers.items():
        port_path, jax_path = _write_both(tmp_path, name, write)
        with open(port_path, "rb") as a, open(jax_path, "rb") as b:
            assert a.read() == b.read(), name
    port_dists, jax_dists = (str(tmp_path / f"{t}_res_dists.csv")
                             for t in ("port", "jax"))
    with open(port_dists, "rb") as a, open(jax_dists, "rb") as b:
        assert a.read() == b.read()
    # and each package reads the other's artifacts back
    port_cent = str(tmp_path / "port_cent.bin")
    for a, b in zip(jio.load_centroids_ref(port_cent), cents):
        np.testing.assert_array_equal(a, b)
    got = io.load_codebook_ref(str(tmp_path / "jax_codes.bin"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, codes)


def test_pad_dims_and_npz_match_jax(tmp_path):
    x = np.ones((4, 10), np.float32)
    for m in (4, 5, 16):
        np.testing.assert_array_equal(io.pad_dims(x, m), jio.pad_dims(x, m))
    arrays = {"a": np.arange(6).reshape(2, 3).astype(np.float32)}
    io.save_index_npz(str(tmp_path / "i.npz"), arrays, {"k": 5})
    a2, m2 = jio.load_index_npz(str(tmp_path / "i.npz"))
    np.testing.assert_array_equal(a2["a"], arrays["a"])
    assert m2 == {"k": 5}


# --- the native module ----------------------------------------------------------

@pytest.fixture(scope="module")
def mod():
    m = native.get()
    if m is None:
        pytest.skip("no compiler: the numpy fallbacks carry the behaviour")
    return m


def test_native_builds_outside_the_source_tree(mod):
    assert hasattr(mod, "pack_codes") and hasattr(mod, "merge_topk")
    assert os.path.dirname(mod.__file__) == str(native.BUILD_DIR)
    assert not os.path.exists(os.path.join(native._HERE, "vaq_native.so"))


def test_native_pack_codes_matches_numpy(mod, monkeypatch):
    rng = np.random.default_rng(0)
    bits = np.array([4, 7, 8, 1, 12, 3, 5], dtype=np.int64)
    buckets = np.stack([rng.integers(0, 1 << int(b), size=200) for b in bits],
                       axis=1)
    got = native.pack_codes(buckets, bits)
    no_native(monkeypatch, jnative)
    np.testing.assert_array_equal(got, jbinary.pack_codes(buckets, bits))


def test_native_read_vecs_matches_numpy(mod, vec_files, monkeypatch):
    paths, _, _ = vec_files
    got = {ext: native.read_vecs(paths[ext], dt, 7) for ext, dt in
           ((".fvecs", np.float32), (".ivecs", np.int32),
            (".bvecs", np.uint8))}
    no_native(monkeypatch, native)
    for ext, fn in ((".fvecs", io.read_fvecs), (".ivecs", io.read_ivecs),
                    (".bvecs", io.read_bvecs)):
        want = fn(paths[ext], 7)
        assert got[ext].dtype == want.dtype
        np.testing.assert_array_equal(got[ext], want)


def test_native_merge_topk_matches_numpy(mod):
    """The in-place merge keeps the k smallest of best ∪ new: the stable
    numpy argsort's distances, and ids that carry them."""
    rng = np.random.default_rng(2)
    nq, k, m = 5, 8, 12
    best_d = np.sort(rng.random((nq, k)).astype(np.float32), axis=1)
    best_i = np.stack([rng.permutation(1000)[:k] for _ in range(nq)]
                      ).astype(np.int32)
    new_d = rng.random((nq, m)).astype(np.float32)
    new_i = (1000 + np.stack([rng.permutation(1000)[:m] for _ in range(nq)])
             ).astype(np.int32)
    cd = np.concatenate([best_d, new_d], axis=1)
    ci = np.concatenate([best_i, new_i], axis=1)
    order = np.argsort(cd, axis=1, kind="stable")[:, :k]
    d2, i2 = best_d.copy(), best_i.copy()
    assert native.merge_topk(d2, i2, new_d, new_i)
    np.testing.assert_array_equal(d2, np.take_along_axis(cd, order, axis=1))
    np.testing.assert_array_equal(i2, np.take_along_axis(ci, order, axis=1))


def test_no_native_falls_back(monkeypatch):
    no_native(monkeypatch, native)
    assert native.pack_codes(np.zeros((1, 1), np.int64),
                             np.ones(1, np.int64)) is None
    assert native.read_vecs("unused", np.float32) is None
    assert native.merge_topk(*(np.zeros((1, 1)),) * 4) is False


# --- index artifacts ------------------------------------------------------------

@pytest.fixture(scope="module")
def art_pair():
    """(base, queries, JAX index, port index on its state):
    tests/test_torch_vaq.py's fixture."""
    from vaq_tpu.data import make_sift_like
    base, queries, _ = make_sift_like(n=8000, n_queries=8, d=64, seed=3)
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    return base, queries, jidx, index_from_numpy(*jax_state(jidx), "cpu")


@pytest.mark.parametrize("wide", [False, True])
def test_export_byte_equal_to_jax(art_pair, tmp_path, wide):
    """The reference's centroid and codebook files (u16 codes) from one
    state, u8 codes or a 9-bit subspace."""
    jidx = art_pair[2]
    arrays, meta = wide_state(jidx) if wide else jax_state(jidx)
    j = _jax_index(arrays, meta)
    t = index_from_numpy(arrays, meta, "cpu")
    files = {}
    for tag, idx in (("port", t), ("jax", j)):
        files[tag] = (str(tmp_path / f"{tag}_c.bin"),
                      str(tmp_path / f"{tag}_k.bin"))
        idx.export_reference_artifacts(*files[tag])
    for a, b in zip(files["port"], files["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("wide", [False, True])
def test_from_reference_artifacts_of_jax_files(art_pair, tmp_path, wide):
    """JAX-written artifacts: the port adopts the codes (int32 on the
    device where a subspace is wider than 8 bits) and the centroids exactly,
    and retrains the rotation to fault 3's tolerance; searches then agree
    with JAX's index rebuilt from the same files."""
    base, queries, jidx, _ = art_pair
    arrays, meta = wide_state(jidx) if wide else jax_state(jidx)
    j = _jax_index(arrays, meta)
    cp, kp = str(tmp_path / "c.bin"), str(tmp_path / "k.bin")
    j.export_reference_artifacts(cp, kp)
    j2 = vaq_tpu.VAQIndex.from_reference_artifacts(j.config, cp, kp, base)
    tcfg = index_from_numpy(arrays, meta, "cpu").config
    t2 = vaq_tpu_torch.VAQIndex.from_reference_artifacts(tcfg, cp, kp, base,
                                                         device="cpu")
    assert t2.device == torch.device("cpu")
    assert t2.codes.dtype == (torch.int32 if wide else torch.uint8)
    np.testing.assert_array_equal(t2.codes_rowmajor(), j2.codes_rowmajor())
    assert t2.codes_rowmajor().dtype == j2.codes_rowmajor().dtype
    np.testing.assert_array_equal(t2.centroids, j2.centroids)
    np.testing.assert_array_equal(t2.bits, j2.bits)
    np.testing.assert_array_equal(t2.centroid_counts, j2.centroid_counts)
    assert (t2.n_rows, t2.highest_subs, t2.subs_len, t2.orig_dim) == \
        (j2.n_rows, j2.highest_subs, j2.subs_len, j2.orig_dim)
    np.testing.assert_allclose(t2.eigvals, j2.eigvals, rtol=1e-5,
                               atol=1e-6 * float(j2.eigvals.max()))
    d_j, i_j = j2.search(queries, 5, backend="decoded")
    d_t, i_t = t2.search(queries, 5, backend="decoded")
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-4)


def test_load_without_codes(art_pair, tmp_path):
    """``with_codes=False`` (vaq.py:1163-1171): every array but the codes;
    searching then needs an encode."""
    base, queries, jidx, tidx = art_pair
    path = str(tmp_path / "x.npz")
    jidx.save(path)
    bare = vaq_tpu_torch.VAQIndex.load(path, device="cpu", with_codes=False)
    assert bare.codes is None and bare.n_rows == tidx.n_rows
    np.testing.assert_array_equal(bare.centroids, tidx.centroids)
    np.testing.assert_array_equal(bare.eigvecs, tidx.eigvecs)
    with pytest.raises(NotReadyError, match="encode"):
        bare.search(queries, 5)
    full = vaq_tpu_torch.VAQIndex.load(path, device="cpu")
    np.testing.assert_array_equal(full.codes_rowmajor(),
                                  jidx.codes_rowmajor())
    bare.encode(base)
    np.testing.assert_array_equal(bare.search(queries, 5)[1],
                                  full.search(queries, 5)[1])
