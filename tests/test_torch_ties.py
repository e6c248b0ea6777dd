"""Ties: where scores are equal, the port returns exactly the ids vaq_tpu
returns, on the CPU.

``jax.lax.top_k`` puts the lower position first among equal values;
``torch.topk`` does not promise any order. The port's selections go through
``scan_codes._select_lowest``, which gives ``jax.lax.top_k(−x)``'s set and
order at any width. The data here are small integers (centroids, queries,
rows), so every distance and score is exact in f32 on both sides, and many
base rows are duplicates, so distances tie bit for bit. The codes tier, the
decoded rescores, refine, an IVF search on one hand-built state and the
codes tier's tombstone filter must then return JAX's ids exactly, not only
as sets. So must the running merges of the decoded tiers and of
``exact_search`` (``distances.lowest_over_blocks`` over several row
blocks), both where ties reach past what a block's ``torch.topk`` kept (the
scan is redone tie-exact) and where they do not (one sort of the kept
entries by value and id).
"""

import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from vaq_tpu import ivf as jivf
from vaq_tpu.ops import distances as jdist
from vaq_tpu.ops import scan_decoded as jdec
from vaq_tpu.ops import scan_jax as jlut
from vaq_tpu.ops import scan_pallas
from vaq_tpu_torch import io as port_io
from vaq_tpu_torch import ivf
from vaq_tpu_torch.convert import index_from_numpy, ivf_state_from_numpy
from vaq_tpu_torch.ops import distances, scan_codes, scan_decoded, scan_lut

torch.set_num_threads(2)  # six test workers share the host


def tie_codes(n, m, c, seed, pool=12):
    """(n, M) u8 codes drawn from ``pool`` distinct rows: most rows have
    duplicates."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, c, (pool, m)).astype(np.uint8)
    return rows[rng.integers(0, pool, n)]


def small_ints(shape, seed, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def assert_tied(d, at_least=1):
    """The result really holds ties among its finite distances."""
    d = np.asarray(d)
    same = (np.diff(d, axis=1) == 0) & np.isfinite(d[:, 1:])
    assert same.sum() >= at_least, same.sum()


@pytest.mark.parametrize("width,k", [(9, 3), (300, 40), (2048, 200),
                                     (2049, 200), (7813, 200), (5000, 4999),
                                     (4096, 200), (4097, 200)])
@pytest.mark.parametrize("form", ["sort", "topk"])
def test_select_lowest_is_jax_top_k(width, k, form):
    """The helper and both of its forms (the whole stable sort, and one
    torch.topk of (score, position) keys) give ``jax.lax.top_k(−x)``'s
    values and positions, with +inf entries, whole rows of them, −0 beside
    +0, and on the int32 scores of the FAST path."""
    lowest = {"sort": scan_codes._lowest_sorted,
              "topk": scan_codes._lowest_keyed}[form]
    x = small_ints((5, width), seed=width, lo=0, hi=5)
    x[0, : width // 2] = np.inf
    x[1] = np.inf
    x[2, -1] = -1.0                         # a single smallest, at the end
    x[3, ::3] = -0.0                        # −0 ties with +0, as in JAX
    neg, want = jax.lax.top_k(-jnp.asarray(x), k)
    xt = torch.as_tensor(x)
    pos = lowest(scan_codes._ordered(xt), k)
    assert pos.dtype == torch.int64
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    vals, pos = scan_codes._select_lowest(xt, k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    xi = x[2:].astype(np.int32)             # K4's integer window sums
    _, want = jax.lax.top_k(-jnp.asarray(xi), k)
    pos = lowest(scan_codes._ordered(torch.as_tensor(xi)), k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    _, pos = scan_codes._select_lowest(torch.as_tensor(xi), k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))


def test_select_lowest_issue_example():
    """The example of torch.topk's other order: JAX keeps [1, 2, 4]."""
    x = torch.tensor([[1.0, 0, 0, 2, 0, 0, 0, 3, 0]])
    assert scan_codes._select_lowest(x, 3)[1].tolist() == [[1, 2, 4]]


# (M, C, L, n, nq, block_rows, k) for the codes tier
CODES_TIES = [(4, 16, 2, 1024, 5, 16, 10), (8, 16, 4, 2048, 3, 64, 6)]


def codes_inputs(geom, seed=0):
    m, c, l, n, nq, _, _ = geom
    cents = small_ints((m, c, l), seed)
    codes = tie_codes(n, m, c, seed + 1)
    qp = small_ints((nq, m * l), seed + 2, -4, 5)
    return cents, codes, qp


@pytest.mark.parametrize("geom", CODES_TIES)
def test_codes_tier_ties_match_jax_exactly(geom):
    """``decode_scan_topk``: the window pick (top-2k) and the rescored top-k
    both break ties as JAX does."""
    cents, codes, qp = codes_inputs(geom)
    br, k = geom[5], geom[6]
    table_j, _ = scan_pallas.build_decode_table(cents)
    d_j, i_j = scan_pallas.decode_scan_topk(
        jnp.asarray(codes.T.copy()), table_j,
        scan_pallas.build_decode_rows(cents), jnp.asarray(qp), k,
        block_rows=br, q_tile=8, interpret=True)
    d_t, i_t = scan_codes.decode_scan_topk(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        scan_codes.build_decode_rows(cents, "cpu"), torch.as_tensor(qp), k,
        block_rows=br)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j, at_least=k)


def test_torch_topk_picks_other_windows():
    """On the same window scores, ``torch.topk`` picks another set than
    ``jax.lax.top_k``; the helper picks JAX's."""
    cents, codes, qp = codes_inputs(CODES_TIES[0])
    scores, _ = scan_codes.decode_window_scan(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        torch.as_tensor(qp), CODES_TIES[0][5])
    _, want = jax.lax.top_k(-jnp.asarray(scores.numpy()), 20)
    _, pos = scan_codes._select_lowest(scores, 20)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    other = torch.topk(scores, 20, dim=1, largest=False, sorted=True).indices
    assert any(set(other[q].tolist()) != set(pos[q].tolist())
               for q in range(scores.shape[0]))


def decoded_inputs(n=96, d=8, nq=4, seed=10):
    """Decoded rows (small ints, duplicated) with exact norms, two
    tombstoned (+inf norms), and small-int queries."""
    codes = tie_codes(n, d, 7, seed, pool=10)
    rows = codes.astype(np.float32) - 3.0
    norms = (rows * rows).sum(1).astype(np.float32)
    norms[[5, 40]] = np.inf
    qp = small_ints((nq, d), seed + 1, -4, 5)
    return rows, norms, qp


def jax_candidates(rows, norms, qp, kk):
    """JAX's exact candidate order for the decoded tiers: top_k of the
    score 2·q·x − ‖x‖², −1 where the score is −inf (exact in f32 here)."""
    score = (2.0 * qp.astype(np.float64) @ rows.T.astype(np.float64)
             - norms[None, :]).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(score), kk)
    return np.where(np.isfinite(np.asarray(vals)), np.asarray(idx),
                    -1).astype(np.int32)


@pytest.mark.parametrize("tier", ["decoded", "decoded8"])
def test_decoded_rescores_ties_match_jax_exactly(monkeypatch, tier):
    """The exact rescore of the bf16 and int8 tiers selects as JAX's does.
    The scan's candidates come in JAX's order (the running merge is not
    tie-exact), so the rescore alone decides the result."""
    rows, norms, qp = decoded_inputs()
    k = 5
    kk = min(max(2 * k, k + 16), rows.shape[0])
    cand = torch.as_tensor(jax_candidates(rows, norms, qp, kk))
    monkeypatch.setattr(scan_decoded, "_scan_topk", lambda *a: cand)
    if tier == "decoded":
        d_j, i_j = jdec.decoded_scan_topk(
            jnp.asarray(rows, jnp.bfloat16), jnp.asarray(norms),
            jnp.asarray(qp), k, exact=True)
        d_t, i_t = scan_decoded.decoded_scan_topk(
            torch.as_tensor(rows).to(torch.bfloat16), torch.as_tensor(norms),
            torch.as_tensor(qp), k)
    else:
        r8 = rows.astype(np.int8)
        ones = np.ones(rows.shape[1], np.float32)
        d_j, i_j = jdec.decoded8_scan_topk(
            jnp.asarray(r8.T.copy()), jnp.asarray(ones), jnp.asarray(norms),
            jnp.asarray(r8.T.copy()), jnp.asarray(qp), k, exact=True)
        d_t, i_t = scan_decoded.decoded8_scan_topk(
            torch.as_tensor(r8), torch.as_tensor(ones),
            torch.as_tensor(norms), torch.as_tensor(qp), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j)


def decoded_tier(tier, rows, norms, qp, k):
    """(JAX's exact=True result, the port's) for one decoded tier."""
    if tier == "decoded":
        want = jdec.decoded_scan_topk(
            jnp.asarray(rows, jnp.bfloat16), jnp.asarray(norms),
            jnp.asarray(qp), k, exact=True)
        got = scan_decoded.decoded_scan_topk(
            torch.as_tensor(rows).to(torch.bfloat16), torch.as_tensor(norms),
            torch.as_tensor(qp), k)
    else:
        r8 = rows.astype(np.int8)
        ones = np.ones(rows.shape[1], np.float32)
        want = jdec.decoded8_scan_topk(
            jnp.asarray(r8.T.copy()), jnp.asarray(ones), jnp.asarray(norms),
            jnp.asarray(r8.T.copy()), jnp.asarray(qp), k, exact=True)
        got = scan_decoded.decoded8_scan_topk(
            torch.as_tensor(r8), torch.as_tensor(ones),
            torch.as_tensor(norms), torch.as_tensor(qp), k)
    return want, got


@pytest.mark.parametrize("slack", [8, 1])
@pytest.mark.parametrize("k", [5, 12])
@pytest.mark.parametrize("tier", ["decoded", "decoded8"])
def test_decoded_tiers_ties_match_jax_exactly(monkeypatch, tier, k, slack):
    """The whole decoded and int8 tiers, blocked scan included, over six
    16-row blocks: JAX's ``exact=True`` ids and distances, with the blocks'
    margin as it is and cut to 1 (so that tie groups outrun it)."""
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", 16)
    monkeypatch.setattr(distances, "TIE_SLACK", slack)
    rows, norms, qp = decoded_inputs()
    (d_j, i_j), (d_t, i_t) = decoded_tier(tier, rows, norms, qp, k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j)


@pytest.mark.parametrize("slack", [8, 1])
@pytest.mark.parametrize("k", [5, 40, 100])
def test_exact_search_ties_match_jax_exactly(monkeypatch, k, slack):
    """``exact_search`` over 16-row blocks against JAX's over 16-row
    blocks: the same ids and distances (at k = 100 > n the +inf / −1 tail
    too), with the blocks' margin as it is and cut to 1."""
    monkeypatch.setattr(distances, "BLOCK_ROWS", 16)
    monkeypatch.setattr(distances, "TIE_SLACK", slack)
    rows, _, qp = decoded_inputs(seed=12)
    d_j, i_j = jdist.exact_search(jnp.asarray(qp), jnp.asarray(rows), k,
                                  block_rows=16)
    d_t, i_t = distances.exact_search(torch.as_tensor(qp),
                                      torch.as_tensor(rows), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j, at_least=k // 2)


@pytest.mark.parametrize("k,sevens,redone", [(2, False, False),
                                              (2, True, True),
                                              (1, False, True)])
def test_lowest_over_blocks_checked_and_redone(monkeypatch, k, sevens,
                                               redone):
    """Each 4-column block keeps its k + 1 lowest by torch.topk. Where no
    tie group reaches the last kept place the scan runs once, and the final
    sort by (value, id) gives JAX's result; where one does (k = 2 with two
    7s in row 1's second block, k = 1 with the 1s of row 0's first), it runs
    again tie-exact, with the same result."""
    monkeypatch.setattr(distances, "TIE_SLACK", 1)
    # at k = 2 every block keeps ties, none at its last kept place
    x = np.array([[1, 1, 6, 9, 0, 0, 9, 8, 7, 5, 5, 6],
                  [2, 2, 9, 8, 0, 8, 7, 9, 3, 3, 6, 4]], np.float32)
    if sevens:
        x[1, 5] = 7
    neg, want = jax.lax.top_k(-jnp.asarray(x), k)
    xt = torch.as_tensor(x)
    calls = []

    def blocks():
        calls.append(1)
        for start in range(0, x.shape[1], 4):
            yield xt[:, start:start + 4], start

    d, i = distances.lowest_over_blocks(blocks, k)
    assert len(calls) == (2 if redone else 1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want))
    np.testing.assert_array_equal(d.numpy(), -np.asarray(neg))


def test_refine_ties_match_jax_exactly():
    """``refine_topk``: duplicate candidate rows tie exactly in the
    original space; −1 labels stay last."""
    rng = np.random.default_rng(20)
    base = small_ints((12, 6), 21)
    labels = np.stack([rng.permutation(36)[:30] for _ in range(4)]
                      ).astype(np.int32)
    labels[:, -2:] = -1
    x = np.concatenate([base] * 3)                 # id i holds row i % 12
    queries = small_ints((4, 6), 22, -4, 5)
    cands = x[np.maximum(labels, 0)]
    d_j, i_j = jlut.refine_topk(jnp.asarray(queries), jnp.asarray(cands),
                                jnp.asarray(labels), 8)
    d_t, i_t = scan_lut.refine_topk(torch.as_tensor(queries),
                                    torch.as_tensor(cands),
                                    torch.as_tensor(labels), 8)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j, at_least=4)


def ivf_tie_state(ncl=4, cap=512, d=16, seg=4, seed=30):
    """A probe state of int8 rows with unit scales (x̂ = the int8 row), all
    slots live, rows drawn from 16 distinct ones, small-int centroids; and
    the flat decoded tier (bf16 rows by id, exact norms)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-3, 4, (16, d)).astype(np.int8)
    rows = pool[rng.integers(0, 16, ncl * cap)]
    ids = rng.permutation(ncl * cap).astype(np.int32)
    flat = np.empty_like(rows)
    flat[ids] = rows
    arrays = {"centroids": small_ints((ncl, seg), seed + 1), "seg_dims": seg,
              "cap": cap, "bucket_rows": rows.reshape(ncl, cap, d),
              "bucket_ids": ids.reshape(ncl, cap),
              "sizes": np.full(ncl, cap, np.int32),
              "dim_scales": np.ones(d, np.float32), "transposed": False}
    flat = flat.astype(np.float32)
    return arrays, flat, (flat * flat).sum(1).astype(np.float32)


@pytest.mark.parametrize("resident", [False, True])
def test_ivf_ties_match_jax_exactly(resident):
    """One IVF state searched by both packages: the window merge (top-m
    group minima), the row pick and, with the decoded tier resident, the
    exact second stage all break ties as JAX does."""
    arrays, flat, norms = ivf_tie_state()
    qp = small_ints((6, flat.shape[1]), 33, -4, 5)
    k, visit = 10, 0.5
    jstate = jivf.IVFState(
        centroids=arrays["centroids"], seg_dims=arrays["seg_dims"],
        cap=arrays["cap"], bucket_rows=jnp.asarray(arrays["bucket_rows"]),
        bucket_ids=jnp.asarray(arrays["bucket_ids"]),
        sizes=jnp.asarray(arrays["sizes"]),
        dim_scales=jnp.asarray(arrays["dim_scales"]))
    j_index = t_index = None
    if resident:
        j_index = types.SimpleNamespace(
            decoded=jnp.asarray(flat, jnp.bfloat16),
            decoded_norms=jnp.asarray(norms))
        t_index = types.SimpleNamespace(
            decoded=torch.as_tensor(flat).to(torch.bfloat16),
            decoded_norms=torch.as_tensor(norms))
    d_j, i_j = jivf.IVFSearcher(jstate, visit).search(
        j_index, jnp.asarray(qp), None, k)
    d_t, i_t = ivf.IVFSearcher(ivf_state_from_numpy(arrays, "cpu"),
                               visit).search(t_index, torch.as_tensor(qp), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j, at_least=k)


def tie_index_state(n=8192, m=4, l=2, seed=40):
    """save()-format arrays and meta of a 4-bit index whose rotation is the
    identity and whose centroids are small integers, over duplicated
    codes."""
    d = m * l
    tidx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ16m4min4max4var1,HEAP"),
        device="cpu").train(small_ints((512, d), seed))
    arrays, meta = tidx.state()
    assert (arrays["bits"] == 4).all() and arrays["centroids"].shape == \
        (m, 16, l)
    arrays["eigvecs"] = np.eye(d, dtype=np.float32)
    arrays["centroids"] = small_ints((m, 16, l), seed + 1)
    arrays["codes"] = tie_codes(n, m, 16, seed + 2)
    meta["n_rows"] = n
    return arrays, meta


def test_codes_tombstone_filter_ties_match_jax_exactly():
    """``search_device(backend="codes")`` with deleted rows: the
    over-fetch of k + #deleted and the on-device filter's top-k pick JAX's
    ids (vaq.py:461-477)."""
    arrays, meta = tie_index_state()
    queries = small_ints((4, 8), 44, -4, 5)
    tidx = index_from_numpy(arrays, meta, "cpu")
    _, i0 = tidx.search_device(torch.as_tensor(queries), 4, backend="codes")
    arrays["deleted_ids"] = np.unique(i0[:, [0, 2]].numpy()).astype(np.int64)
    buf = io.BytesIO()
    port_io.save_index_npz(buf, arrays, meta)
    buf.seek(0)
    jidx = vaq_tpu.VAQIndex.load(buf)
    tdel = index_from_numpy(arrays, meta, "cpu")
    d_j, i_j = jidx.search_device(jnp.asarray(queries), 4, backend="codes",
                                  exact=True)
    d_t, i_t = tdel.search_device(torch.as_tensor(queries), 4,
                                  backend="codes")
    assert not np.isin(i_t.numpy(), arrays["deleted_ids"]).any()
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j)
