"""Port parity of the codebooks above 8 bits (vaq_tpu_torch/kmeans.py: the
k-means++ init, the mini-batch fit, the hierarchical and the binary-split
fits) and of the training and encoding that use them, against
vaq_tpu/kmeans.py and vaq_tpu/vaq.py on the CPU (tests/test_kmeans.py:35-80,
tests/test_vaq_e2e.py:197-210, 278).

The inits are numpy draws, copied call for call, so they are bit-equal. The
fits drift from JAX's in the last bits (f32 sums in another order), so on
random data they are held to JAX's inertia: within 1e-3 for the flat fits
(one init, one Lloyd run) and within 1e-2 for the hierarchical and
binary-split fits, where a point that changes coarse cluster or side moves
a whole sub-fit. On crafted data of far-apart integer sites, where every
distance and mean is exact in f32, each degenerate branch of the two wide
fits (an empty coarse cluster, at most k_sub members, a side too small for
its leaves, fewer rows than half the leaves, a leaf's mean) gives JAX's
centroids exactly. A trained wide index is held to JAX's bits exactly and
to its decoded-tier recall within 0.05.
"""

import dataclasses

import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from vaq_tpu import kmeans as jkmeans
from vaq_tpu_torch import kmeans, metrics
from vaq_tpu_torch.ops.distances import exact_search

torch.set_num_threads(2)  # six test workers share the host


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4))
            * np.array([3.0, 2.0, 1.0, 0.5])).astype(np.float32)


def inertia(x, c):
    """Σ min_c ‖x − c‖² in f64."""
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    return float(((x[:, None, :] - c[None]) ** 2).sum(2).min(1).sum())


def assert_inertia_close(x, c_port, c_jax, rtol):
    got, want = inertia(x, c_port), inertia(x, c_jax)
    assert abs(got / want - 1.0) <= rtol, (got, want)


# --- inits --------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(500, 32, 1), (40, 64, 2), (300, 1, 3)])
def test_inits_bit_equal_to_jax(n, k, seed):
    """n < k draws the subset with repetition; the D² init needs n ≥ k
    distinct rows in both packages."""
    x = _data(n, seed)
    np.testing.assert_array_equal(kmeans.init_subset(x, k, seed),
                                  jkmeans.init_subset(x, k, seed))
    if n >= k:
        np.testing.assert_array_equal(kmeans.init_kmeanspp(x, k, seed),
                                      jkmeans.init_kmeanspp(x, k, seed))


# --- flat fits ------------------------------------------------------------------

@pytest.mark.parametrize("init", ["kmeans++", "subset"])
def test_fit_init_matches_jax(init):
    x = _data(3000)
    cj, aj = jkmeans.fit(x, 64, iters=10, init=init, seed=5)
    ct, at = kmeans.fit(torch.as_tensor(x), 64, iters=10, init=init, seed=5)
    assert ct.shape == (64, 4) and at.shape == (3000,)
    assert_inertia_close(x, ct.numpy(), cj, 1e-3)
    assert (at.numpy() == np.asarray(aj)).mean() >= 0.99


def test_fit_minibatch_matches_jax():
    x = _data(3000, 1)
    cj, aj = jkmeans.fit_minibatch(x, 32, iters=20, batch_size=512, seed=5)
    ct, at = kmeans.fit_minibatch(torch.as_tensor(x), 32, iters=20,
                                  batch_size=512, seed=5)
    assert_inertia_close(x, ct.numpy(), cj, 1e-3)
    assert (at.numpy() == np.asarray(aj)).mean() >= 0.99
    # it moves from its init toward a better fit
    assert inertia(x, ct.numpy()) < inertia(x, kmeans.init_subset(x, 32, 5))


# --- two-level and recursive fits --------------------------------------------------

@pytest.mark.parametrize("bits", [9, 10])
def test_hierarchical_fit_matches_jax(bits):
    x = _data(3000, 2)
    cj = jkmeans.hierarchical_fit(x, bits, iters=10, seed=3)
    ct = kmeans.hierarchical_fit(torch.as_tensor(x), bits, iters=10, seed=3)
    assert ct.shape == cj.shape == (1 << bits, 4)
    assert_inertia_close(x, ct.numpy(), cj, 1e-2)


def test_binary_split_fit_matches_jax():
    """300 rows to 2^9 leaves: deep enough to reach every branch, small
    enough for JAX, which compiles its fit once per node size."""
    x = _data(300, 3)
    cj = jkmeans.binary_split_fit(x, 9, iters=5, seed=3)
    ct = kmeans.binary_split_fit(torch.as_tensor(x), 9, iters=5, seed=3)
    assert ct.shape == cj.shape == (512, 4)
    assert_inertia_close(x, ct.numpy(), cj, 1e-2)


def sites(spec):
    """Rows of integer sites, each repeated: [((x, y), copies), ...]."""
    return np.concatenate([np.tile(np.array(p, np.float32), (c, 1))
                           for p, c in spec])


# a lone-copy site, a lone triple, a big duplicated site and two near sites
# that share one coarse cluster (two distinct values, more than k_sub rows)
HIER_SITES = [((0, 0), 12), ((40, 0), 3), ((0, 40), 10), ((2, 40), 10),
              ((40, 40), 1)]


@pytest.mark.parametrize("seed", [2, 3])
def test_hierarchical_degenerate_branches_exact(seed):
    """Four coarse clusters of 2^2 sub-centroids: these seeds leave one
    coarse cluster empty (it repeats its coarse centroid), one with 3 ≤ k_sub
    members (repeated cyclically) and two with more (resampled to s_fit and
    sub-fitted)."""
    x = sites(HIER_SITES)
    _, assign = jkmeans.fit(x, 4, iters=5, seed=seed)
    counts = np.bincount(np.asarray(assign), minlength=4)
    assert 0 in counts and 3 in counts and (counts > 4).sum() == 2, counts
    cj = jkmeans.hierarchical_fit(x, 4, iters=5, seed=seed, coarse_bits=2)
    ct = kmeans.hierarchical_fit(torch.as_tensor(x), 4, iters=5, seed=seed,
                                 coarse_bits=2)
    np.testing.assert_array_equal(ct.numpy(), cj)


BINARY_CASES = {
    # bits = 1: one 2-means, then each side's mean (depth 0)
    "leaf means": (sites([((0, 0), 2), ((0, 2), 2), ((60, 0), 4)]), 1),
    # 3 rows for 2^3 leaves: fewer than half of them, repeated cyclically
    "too few rows": (sites([((0, 0), 1), ((4, 4), 1), ((8, 0), 1)]), 3),
    # an outlier alone on its side, too small for its 8 leaves: the flat
    # 16-means of the whole node
    "side too small": (sites([((0, 0), 16), ((0, 2), 16), ((2, 0), 16),
                              ((2, 2), 16), ((100, 100), 1)]), 4),
}


@pytest.mark.parametrize("case", sorted(BINARY_CASES))
def test_binary_split_degenerate_branches_exact(case, monkeypatch):
    x, bits = BINARY_CASES[case]
    seen = []
    fit = kmeans.fit

    def counting_fit(data, k, **kw):
        seen.append(k)
        return fit(data, k, **kw)

    monkeypatch.setattr(kmeans, "fit", counting_fit)
    ct = kmeans.binary_split_fit(torch.as_tensor(x), bits, iters=5, seed=7)
    cj = jkmeans.binary_split_fit(x, bits, iters=5, seed=7)
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert ct.shape == (1 << bits, 2)
    if case == "too few rows":
        assert seen == []
    elif case == "side too small":
        assert seen == [2, 16]


def sequential_hierarchical(x, bits, iters, seed, coarse_bits=7):
    """JAX's loop (vaq_tpu/kmeans.py:221-263) over the port's own ``fit``:
    one sub-fit after another."""
    k_coarse, k_sub = 1 << coarse_bits, 1 << (bits - coarse_bits)
    coarse, assign = kmeans.fit(x, k_coarse, iters=iters, seed=seed)
    assign, xn = assign.numpy(), x.numpy()
    out = np.empty((k_coarse * k_sub, x.shape[1]), np.float32)
    s_fit = int(min(x.shape[0], 256 * k_sub))
    rng = np.random.default_rng(seed)
    for i in range(k_coarse):
        members = xn[assign == i]
        if members.shape[0] == 0:
            out[i * k_sub:(i + 1) * k_sub] = coarse[i].numpy()
            continue
        if members.shape[0] <= k_sub:
            out[i * k_sub:(i + 1) * k_sub] = np.resize(members,
                                                       (k_sub, x.shape[1]))
            continue
        if members.shape[0] > s_fit:
            members = members[rng.choice(members.shape[0], s_fit,
                                         replace=False)]
        elif members.shape[0] < s_fit:
            members = members[rng.integers(0, members.shape[0], s_fit)]
        sub, _ = kmeans.fit(torch.as_tensor(members), k_sub, iters=iters,
                            seed=seed + i + 1)
        out[i * k_sub:(i + 1) * k_sub] = sub.numpy()
    return out


@pytest.mark.parametrize("bits,n", [(9, 3000), (10, 3000), (9, 500)])
def test_hierarchical_batched_equals_sequential(bits, n):
    """The batched sub-fits are the sequential ones: the same members, draws
    and inits, one batched Lloyd. On the CPU the batched matmul adds in the
    sequential order too, so the two are bit-equal."""
    x = torch.as_tensor(_data(n, 4))
    np.testing.assert_array_equal(
        kmeans.hierarchical_fit(x, bits, iters=10, seed=3).numpy(),
        sequential_hierarchical(x, bits, 10, 3))


# --- encode_chunks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_pair():
    """(base, queries, JAX index, port index) of one hierarchical config
    with 9- and 10-bit subspaces (tests/test_vaq_e2e.py:197-210), trained
    by each package on the same data."""
    from vaq_tpu.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(2000, 16, 20, seed=6)
    cfg = dataclasses.replace(
        vaq_tpu.parse_method_string("VAQ38m4min8max10var1,HEAP"),
        hierarchical_kmeans=True, kmeans_iters=10)
    jidx = vaq_tpu.VAQIndex(cfg).build(base)
    tcfg = vaq_tpu_torch.VAQConfig(**dataclasses.asdict(cfg))
    tidx = vaq_tpu_torch.VAQIndex(tcfg, device="cpu").build(base)
    return base, queries, jidx, tidx


def assert_codes_tie(idx, x, codes_a, codes_b, rtol=1e-5):
    """Two encodings of ``x`` differ only where the two centroids are
    equally near in f64, to ``rtol`` of the terms ‖x_s‖² + ‖c‖²."""
    rows, subs = np.nonzero(codes_a != codes_b)
    l = idx.subs_len
    xp = (np.asarray(x, np.float64) @ idx.eigvecs[:, :idx.total_dim])
    xs = xp.reshape(len(x), -1, l)[rows, subs]
    cent = idx.centroids.astype(np.float64)

    def dist(codes):
        c = cent[subs, codes[rows, subs].astype(np.int64)]
        return ((xs - c) ** 2).sum(1), (xs * xs).sum(1) + (c * c).sum(1)

    (d_a, scale), (d_b, _) = dist(codes_a), dist(codes_b)
    assert (np.abs(d_a - d_b) <= rtol * scale).all()
    return len(rows)


@pytest.mark.parametrize("chunk_rows", [1, 333, 2000, 5000])
def test_encode_chunks_equals_encode(wide_pair, chunk_rows):
    """At one chunk size, encode's host chunks and device-tensor chunks give
    the same codes, bit for bit. Across chunk sizes the projection is a
    matmul of another shape, summed in another order, so a code may differ
    from the one-chunk encode where its two centroids tie to the last bits
    (``assert_codes_tie``)."""
    base, _, _, tidx = wide_pair
    one_chunk = tidx.codes.clone()
    tidx.encode(base, chunk_rows=chunk_rows)
    host = tidx.codes.clone()
    dev = torch.as_tensor(base)
    tidx.encode_chunks(lambda i: dev[i * chunk_rows:(i + 1) * chunk_rows],
                       len(base), chunk_rows)
    assert torch.equal(tidx.codes, host) and tidx.n_rows == len(base)
    tidx.codes = one_chunk
    assert_codes_tie(tidx, base, host.numpy(), one_chunk.numpy())


def test_encode_chunks_pads_narrow_rows():
    """d = 30 rows for M = 8 subspaces: chunks arrive 30 wide and are
    zero-padded to 32 on the device, as io.pad_dims pads encode's rows."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((600, 30)).astype(np.float32)
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ48m8min4max8var1,HEAP"),
        device="cpu").build(x)
    want = idx.codes.clone()
    idx.encode_chunks(lambda i: x[i * 250:(i + 1) * 250], 600, 250)
    assert torch.equal(idx.codes, want)


# --- training ---------------------------------------------------------------------------

def test_hierarchical_train_matches_jax(wide_pair):
    """min8max10 with hierarchical k-means: JAX's bits exactly, int32 codes
    on the device (u16 where they leave), decoded-tier recall within 0.05
    of JAX's (tests/test_vaq_e2e.py:197-210)."""
    base, queries, jidx, tidx = wide_pair
    np.testing.assert_array_equal(tidx.bits, jidx.bits)
    assert int(tidx.bits.max()) == 10 and (tidx.bits > 8).sum() >= 2
    assert tidx.codes.dtype == torch.int32
    assert tidx.codes_rowmajor().dtype == jidx.codes_rowmajor().dtype
    gt = exact_search(torch.as_tensor(queries), torch.as_tensor(base),
                      10)[1].numpy()
    r_j = metrics.avg_recall(jidx.search(queries, 10, backend="decoded")[1],
                             gt, 10)
    r_t = metrics.avg_recall(tidx.search(queries, 10, backend="decoded")[1],
                             gt, 10)
    assert abs(r_t - r_j) <= 0.05, (r_t, r_j)
    assert r_t >= 0.5, r_t


def test_binary_split_train_matches_jax():
    """min8max9 with binary-split k-means on 300 rows (JAX compiles a fit
    per node size, so the rows stay few): JAX's bits, and decoded-tier
    recall within 0.05 of JAX's."""
    from vaq_tpu.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(300, 16, 20, seed=9)
    cfg = dataclasses.replace(
        vaq_tpu.parse_method_string("VAQ34m4min8max9var1,HEAP"),
        binary_kmeans=True, kmeans_iters=5)
    jidx = vaq_tpu.VAQIndex(cfg).build(base)
    tidx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.VAQConfig(**dataclasses.asdict(cfg)),
        device="cpu").build(base)
    np.testing.assert_array_equal(tidx.bits, jidx.bits)
    assert (tidx.bits == 9).sum() >= 1
    gt = exact_search(torch.as_tensor(queries), torch.as_tensor(base),
                      10)[1].numpy()
    r_j = metrics.avg_recall(jidx.search(queries, 10, backend="decoded")[1],
                             gt, 10)
    r_t = metrics.avg_recall(tidx.search(queries, 10, backend="decoded")[1],
                             gt, 10)
    assert abs(r_t - r_j) <= 0.05, (r_t, r_j)


def test_wide_training_twice_is_bit_equal(wide_pair):
    base, _, _, tidx = wide_pair
    again = vaq_tpu_torch.VAQIndex(tidx.config, device="cpu").build(base)
    np.testing.assert_array_equal(again.eigvecs, tidx.eigvecs)
    np.testing.assert_array_equal(again.centroids, tidx.centroids)
    assert torch.equal(again.codes, tidx.codes)
