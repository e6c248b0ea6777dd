"""The port's CUDA kernels (K1 ``decode_window_scan``, K2
``decode_rescore``, K3/K4 ``fast4_window_scan``, K5 ``groupmin_window_scan``,
K7 ``gather_rescore``, H1 ``popcount_dists``, D1 ``decoded_topk_scan``)
against their plain PyTorch
versions, on a CUDA card, also on state that ``add`` grew and ``delete``
poisoned, and the binary engine's searches on the card against the CPU.

Every test here is marked ``gpu`` and skips without a card. The file
imports neither jax nor vaq_tpu, so on the machine with the card it runs
without them:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

The helpers are shared with tests/test_torch_scan_codes.py,
test_torch_groupmin.py and test_torch_gather_rescore.py, which hold the
plain versions against vaq_tpu's Pallas kernels on the CPU. K3 and K4 add
the same entries in the same order as their plain version (K3 in f32, one
subspace after another; K4 in int32), so their keys are equal bit for bit.
The tolerance rules live in ``vaq_tpu_torch/ops/kernel_check.py``, the
package's on-card gate, which holds the kernels to them on a live index;
the helpers below call them. Tolerances: K1's
scores keep only 23 − idx_bits mantissa bits, so they agree to 1e-5 plus one
packed-key step, 2^(idx_bits − 23) relative, and window winners agree
except where two rows tie within that; K2 sums squares: rtol 1e-5. K5 and
K7 multiply bf16 by int8 or bf16 values, products exact in f32, and sum the
same terms in another order, so they agree to 1e-5 of the size of those
terms (Σ|products| + norms, ``groupmin_term_scale``/``rescore_term_scale``);
a score near 0 is a sum of terms of hundreds, and its last bits differ.
H1's Hamming distances are integers and its Jaccard distances one IEEE
division of integers: bit-equal, and the binary searches built on them
return identical ids and distances on the card and on the CPU. D1 sums the
same exact bf16 products as the plain blocked scan in another order, so its
kk candidates are the plain scan's except where rows tie within 1e-5 of the
terms summed (``kernel_check.d1_check``).
"""

import numpy as np
import pytest
import torch

import vaq_tpu_torch
from vaq_tpu_torch import ivf
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch import binary
from vaq_tpu_torch.ops import (hamming, kernel_check, probe_scan, rescore,
                               scan_codes, scan_decoded)
from vaq_tpu_torch.ops.kernel_check import (groupmin_term_scale,
                                            rescore_term_scale)

# (M, C, L, n, block_rows), tests/test_scan_pallas.py:147-148
GEOMETRIES = [(8, 16, 4, 1024, 16), (32, 256, 4, 4096, 64),
              (16, 4, 8, 1024, 16)]


def make_inputs(geom, seed=31, nq=4):
    m, c, l, n, _ = geom
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    qp = rng.standard_normal((nq, m * l)).astype(np.float32)
    return cents, codes, qp


def assert_windows_match(cents, codes, qp, s_a, i_a, s_b, i_b, block_rows):
    """Two K1 results agree by ``kernel_check.k1_check`` relative to the
    score: scores to the packed-key tolerance, and where the winning rows
    differ, the two rows score the same in f64, on at most 1% of windows."""
    table = scan_codes.build_decode_table(cents, "cpu")
    ok, detail = kernel_check.k1_check(codes, table, qp, (s_a, i_a),
                                       (s_b, i_b), block_rows, of_terms=False)
    assert ok, detail


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


# (M, C, L, n, block_rows, nq, duplicate rows) for K1
K1_CASES = [g + (70, False) for g in GEOMETRIES + [
    (32, 256, 4, 100_000, 128),   # the main shape's windows, cut in rows
    (8, 16, 4, 1000, 24),         # ragged n, windows not tile-aligned
    (512, 4, 1, 2000, 1),         # d = 512 in depth slices, one-row windows
]] + [
    (6, 16, 5, 3000, 64, 70, False),       # d = 30: not a multiple of 16
    (64, 16, 2, 100_000, 128, 70, False),  # the FAST "auto" shape, C = 16
    (32, 256, 4, 50_000, 64, 130, False),  # 64-row windows, two sub-tiles
    (32, 256, 4, 50_000, 512, 70, False),  # windows span four tiles
    (32, 256, 4, 50_000, 32, 70, False),   # the sharded codes tier's 32
    (32, 256, 4, 50_000, 256, 70, False),  # windows span two tiles
    (32, 256, 4, 20_000, 128, 488, False),  # a ragged last query sub-tile
    (32, 256, 4, 10_000, 128, 600, False),  # two query chunks
    (128, 16, 4, 3000, 16, 40, False),     # d = 512 at 16-row windows
    (8, 16, 4, 4096, 64, 70, True),        # duplicate rows: windows tie
    (57, 256, 1, 100_000, 128, 70, False),  # ScalarLUTIndex: M' = 57, L = 1
]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", K1_CASES)
def test_decode_window_scan_kernel_matches_plain(cuda, geom):
    *geom, nq, dup = geom
    cents, codes, qp = make_inputs(geom, nq=nq)
    if dup:  # every row one of 16: many rows of a window tie exactly
        codes = codes[np.random.default_rng(3).integers(0, 16, len(codes))]
    br = geom[4]
    table = scan_codes.build_decode_table(cents, cuda)
    c, q = torch.as_tensor(codes, device=cuda), torch.as_tensor(qp, device=cuda)
    before = scan_codes.decode_window_scan.launches
    s_k, i_k = scan_codes.decode_window_scan(c, table, q, br)
    torch.cuda.synchronize()
    assert scan_codes.decode_window_scan.launches == before + 1
    s_r, i_r = scan_codes.decode_window_scan_ref(c, table, q, br)
    assert_windows_match(cents, codes, qp, s_k.cpu(), i_k.cpu(), s_r.cpu(),
                         i_r.cpu(), br)


# (M, C, L, n) for K2: K1_CASES' geometries — GEOMETRIES, d = 30 (not a
# multiple of 4), d = 512 at L = 1 and at L = 4, the FAST "auto" shape
# (C = 16, L = 2) and the main shape (M = 32, C = 256)
K2_GEOMETRIES = [g[:4] for g in GEOMETRIES] + [
    (6, 16, 5, 3000), (512, 4, 1, 2000), (128, 16, 4, 3000),
    (64, 16, 2, 100_000), (32, 256, 4, 100_000), (57, 256, 1, 100_000)]


@pytest.mark.gpu
@pytest.mark.parametrize("kk", [200, 37])   # the path's 2k, and a ragged one
@pytest.mark.parametrize("geom", K2_GEOMETRIES)
def test_decode_rescore_kernel_matches_plain(cuda, geom, kk):
    cents, codes, qp = make_inputs(geom + (1,), nq=9)
    n = geom[3]
    rng = np.random.default_rng(1)
    cand = rng.integers(0, n, (9, kk)).astype(np.int32)
    cand[0, 0], cand[3, 5], cand[-1, -1] = -1, n, n + 7   # +inf
    args = (torch.as_tensor(codes, device=cuda),
            torch.as_tensor(cand, device=cuda),
            scan_codes.build_decode_rows(cents, cuda),
            torch.as_tensor(qp, device=cuda))
    before = scan_codes.decode_rescore.launches
    got = scan_codes.decode_rescore(*args)
    torch.cuda.synchronize()
    assert scan_codes.decode_rescore.launches == before + 1
    ref = scan_codes.decode_rescore_ref(*args)
    bad = (cand < 0) | (cand >= n)
    assert torch.isinf(got.cpu()[torch.as_tensor(bad)]).all()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def bf16_values(x):
    """f32 numpy array holding ``x`` rounded to bf16 (round-to-nearest-even)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def make_rows(n, d, dtype, rng, dead_tail=0, group=None):
    """(rows, dim_w) as the buckets hold them: int8 rows of scale 32 with
    w = 1/32², or bf16 rows with w = 1; the last ``dead_tail`` rows of every
    ``group`` rows hold the int8 poison pattern / the bf16 sentinel."""
    rows = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "int8":
        rows = np.clip(np.round(rows * 32.0), -127, 127).astype(np.int8)
        dead = probe_scan.poison_pattern(d)
        w = np.full((d,), 1.0 / (32.0 * 32.0), np.float32)
    else:
        dead = np.full((d,), 1e15, np.float32)
        w = np.ones((d,), np.float32)
    if dead_tail:
        rows.reshape(-1, group, d)[:, -dead_tail:] = dead
    return (rows if dtype == "int8" else bf16_values(rows)), w


def to_rows(rows, device):
    t = torch.as_tensor(rows, device=device)
    return t if t.dtype == torch.int8 else t.to(torch.bfloat16)


def make_groupmin_inputs(ncl, cap, qcap, d, dtype, seed=0):
    """K5 inputs as numpy: qsl (ncl, qcap, d) f32 holding bf16 values of
    −2q, rows (ncl·cap, d), dim_w (d,); three poison slots per bucket."""
    rng = np.random.default_rng(seed)
    rows, w = make_rows(ncl * cap, d, dtype, rng, dead_tail=3, group=cap)
    q = rng.standard_normal((ncl, qcap, d)).astype(np.float32)
    return bf16_values(-2.0 * q), rows, w


def make_rescore_inputs(nq, m, gs, d, nblk, dtype, seed=0):
    """K7 inputs as numpy: q (nq, d) f32, dim_w (d,), rows (nblk·gs, d),
    wblk (nq, m) int32 window ids."""
    rng = np.random.default_rng(seed)
    rows, w = make_rows(nblk * gs, d, dtype, rng)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    wblk = rng.integers(0, nblk, size=(nq, m)).astype(np.int32)
    return q, w, rows, wblk


def assert_scores_close(got, ref, scale=None, rtol=1e-5):
    """Same finite pattern, and |got − ref| ≤ rtol·scale, the scale being
    max(|ref|, 1) unless given (``kernel_check.scores_within``)."""
    ok, detail = kernel_check.scores_within(got, ref, scale, rtol)
    assert ok, detail


# (ncl, cap, qcap, d, gs): the 1M bucket shape (scaled down), ragged slot
# tiles, d = 96 (the K6 case) and 64, groups shorter and longer than the
# kernel's 128-row tile, slots in three 128-slot chunks, d = 96 at gs = 8, a
# bucket that ends in half a tile, and d = 960 (GIST), whose tiles do not fit
# in shared memory whole and go in depth slices
GROUPMIN_SHAPES = [(3, 512, 128, 128, 8), (2, 1536, 112, 128, 8),
                   (2, 1024, 40, 96, 16), (2, 512, 70, 64, 64),
                   (1, 2048, 33, 128, 256), (2, 1024, 65, 96, 128),
                   (2, 1536, 300, 128, 8), (2, 1024, 112, 96, 8),
                   (2, 576, 40, 128, 16), (1, 512, 20, 960, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("shape", GROUPMIN_SHAPES)
@pytest.mark.parametrize("slots", [False, True])
def test_groupmin_window_scan_kernel_matches_plain(cuda, dtype, shape, slots):
    ncl, cap, qcap, d, gs = shape
    qsl, rows, w = make_groupmin_inputs(ncl, cap, qcap, d, dtype)
    args = (torch.as_tensor(qsl, device=cuda).to(torch.bfloat16),
            to_rows(rows, cuda), torch.as_tensor(w, device=cuda), ncl, cap, gs)
    n_slots = None
    if slots:  # occupied slots per cluster, one cluster empty
        n_slots = torch.as_tensor(
            np.random.default_rng(2).integers(0, qcap + 1, ncl).astype(np.int32),
            device=cuda)
        n_slots[0] = 0
    before = probe_scan.groupmin_window_scan.launches
    got = probe_scan.groupmin_window_scan(*args, n_slots)
    torch.cuda.synchronize()
    assert probe_scan.groupmin_window_scan.launches == before + 1
    ref = probe_scan.groupmin_window_scan_ref(*args, n_slots)
    assert got.shape == (ncl, qcap, cap // gs)
    assert_scores_close(got.cpu(), ref.cpu(),
                        groupmin_term_scale(qsl, rows, w, ncl, cap, gs))


# (ncl, cap, qcap, d, gs) with n_slots (qcap, 0, 2·qcap/3 + 1, 17): one
# cluster full, one empty, two with live slots that end inside a 16-slot tile
# (and, at qcap = 300, inside the second 128-slot chunk)
PARTIAL_SLOT_SHAPES = [(4, 1536, 112, 128, 8), (4, 1024, 300, 128, 8),
                       (4, 1024, 112, 96, 8), (4, 2048, 70, 128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("shape", PARTIAL_SLOT_SHAPES)
def test_groupmin_window_scan_kernel_partial_slots(cuda, dtype, shape):
    ncl, cap, qcap, d, gs = shape
    qsl, rows, w = make_groupmin_inputs(ncl, cap, qcap, d, dtype, seed=4)
    args = (torch.as_tensor(qsl, device=cuda).to(torch.bfloat16),
            to_rows(rows, cuda), torch.as_tensor(w, device=cuda), ncl, cap, gs)
    n_slots = torch.tensor([qcap, 0, 2 * qcap // 3 + 1, 17], dtype=torch.int32,
                           device=cuda)
    got = probe_scan.groupmin_window_scan(*args, n_slots)
    torch.cuda.synchronize()
    ref = probe_scan.groupmin_window_scan_ref(*args, n_slots)
    assert torch.isinf(got[1]).all() and torch.isinf(got[3, 17:]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[3, :17]).all()
    assert_scores_close(got.cpu(), ref.cpu(),
                        groupmin_term_scale(qsl, rows, w, ncl, cap, gs))


# (nq, m, gs, d, nblk), tests/test_rescore_pallas.py:39-44 and d = 96 (K8);
# then the path's shape cut in queries and rows, d = 960 (GIST) and d =
# 2048 (bf16 rows in two column passes), windows longer than one ring slot
# (gs = 128, and gs = 24 at d = 960: 16-64 KB windows in 8 KB chunks), one
# query, and more windows than the buckets hold (m > nblk: every query
# repeats window ids)
RESCORE_SHAPES = [(16, 20, 16, 128, 64), (8, 20, 64, 128, 32),
                  (5, 6, 8, 128, 16), (32, 4, 256, 96, 8), (7, 9, 8, 96, 30),
                  (64, 200, 8, 128, 4096), (6, 12, 8, 960, 40),
                  (2, 6, 8, 2048, 5), (3, 5, 128, 128, 12),
                  (2, 3, 24, 960, 4), (1, 50, 8, 128, 64), (4, 40, 8, 128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("shape", RESCORE_SHAPES)
def test_gather_rescore_kernel_matches_plain(cuda, dtype, shape):
    nq, m, gs, d, nblk = shape
    q, w, rows, wblk = make_rescore_inputs(nq, m, gs, d, nblk, dtype)
    if m > nblk:
        assert all(len(np.unique(r)) < m for r in wblk)   # duplicates
    wblk[0, 0], wblk[-1, -1] = -1, nblk        # out of range: NaN
    args = (torch.as_tensor(q, device=cuda), torch.as_tensor(w, device=cuda),
            to_rows(rows, cuda), torch.as_tensor(wblk, device=cuda), gs)
    before = rescore.gather_rescore.launches
    got = rescore.gather_rescore(*args)
    torch.cuda.synchronize()
    assert rescore.gather_rescore.launches == before + 1
    ref = rescore.gather_rescore_ref(*args)
    assert torch.isnan(got[0, 0]).all() and torch.isnan(got[-1, -1]).all()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    ok = np.ones(wblk.shape, bool)
    ok[0, 0] = ok[-1, -1] = False
    assert_scores_close(got[ok], ref[ok],
                        rescore_term_scale(q, w, rows, wblk, gs)[ok])


# The 100M probe's shapes (DEEP-100M: 1000 clusters of capacity 102,400,
# gs = pick_gs(102400) = 256, int8 rows at d = 96), cut in clusters and
# queries. K5: two buckets, 136 slots (two 128-slot chunks), one bucket's
# slots all occupied, the other's to 70. K7: visit's m = max(2k, 16) = 20
# windows a query at k = 10, 256 rows each (24 KB: eight 32-row chunks of
# 3 KB in the ring), 64 queries over two buckets' 800 windows.
DEEP_CAP, DEEP_D = 102_400, 96


@pytest.mark.gpu
def test_groupmin_window_scan_kernel_at_100m_shape(cuda):
    ncl, qcap = 2, 136
    gs = probe_scan.pick_gs(DEEP_CAP)
    assert gs == 256
    qsl, rows, w = make_groupmin_inputs(ncl, DEEP_CAP, qcap, DEEP_D, "int8",
                                        seed=6)
    args = (torch.as_tensor(qsl, device=cuda).to(torch.bfloat16),
            to_rows(rows, cuda), torch.as_tensor(w, device=cuda), ncl,
            DEEP_CAP, gs)
    n_slots = torch.tensor([qcap, 70], dtype=torch.int32, device=cuda)
    before = probe_scan.groupmin_window_scan.launches
    got = probe_scan.groupmin_window_scan(*args, n_slots)
    torch.cuda.synchronize()
    assert probe_scan.groupmin_window_scan.launches == before + 1
    ref = probe_scan.groupmin_window_scan_ref(*args, n_slots)
    assert got.shape == (ncl, qcap, DEEP_CAP // gs)
    assert torch.isinf(got[1, 70:]).all() and torch.isfinite(got[0]).all()
    assert_scores_close(got.cpu(), ref.cpu(),
                        groupmin_term_scale(qsl, rows, w, ncl, DEEP_CAP, gs))


@pytest.mark.gpu
def test_gather_rescore_kernel_at_100m_shape(cuda):
    nq, m, gs = 64, 20, probe_scan.pick_gs(DEEP_CAP)
    nblk = 2 * DEEP_CAP // gs
    q, w, rows, wblk = make_rescore_inputs(nq, m, gs, DEEP_D, nblk, "int8",
                                           seed=7)
    args = (torch.as_tensor(q, device=cuda), torch.as_tensor(w, device=cuda),
            to_rows(rows, cuda), torch.as_tensor(wblk, device=cuda), gs)
    before = rescore.gather_rescore.launches
    got = rescore.gather_rescore(*args)
    torch.cuda.synchronize()
    assert rescore.gather_rescore.launches == before + 1
    ref = rescore.gather_rescore_ref(*args)
    assert got.shape == (nq, m, gs)
    assert_scores_close(got.cpu().numpy(), ref.cpu().numpy(),
                        rescore_term_scale(q, w, rows, wblk, gs))


# (n, M, C, nq, block_rows) for K3/K4: the main FAST shape cut in rows, the
# C = 256 shape (the gather form), windows that span blocks or are not
# warp-aligned, M with a ragged last code word, one-row windows, C = 8, and
# several query tiles; then the main shape's widths at 488 queries (the
# second batch of 1000) and at 129 (two tiles and one query), 512-row
# windows, 64-row windows whose last data tile is partial, and C = 64 (the
# tensor-core form's one-hot build for tables wider than 16)
FAST4_SHAPES = [(100_000, 64, 16, 70, 256), (32_768, 32, 256, 20, 512),
                (5000, 8, 16, 9, 24), (3000, 13, 16, 5, 16),
                (2000, 4, 8, 3, 1), (40_000, 64, 16, 600, 512),
                (200_000, 64, 16, 488, 256), (200_000, 64, 16, 129, 256),
                (100_000, 64, 16, 70, 512), (50_037, 64, 16, 70, 64),
                (20_000, 16, 64, 40, 128)]


@pytest.fixture(scope="module")
def k3_rounding():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return scan_codes.k3_accumulation_rounding(torch.device("cuda"))


def assert_k3_matches(codes, luts, br, got, want):
    """K3 against its plain version where the tensor cores do not add to
    nearest, by ``kernel_check.k3_check``: scores within 1e-5 +
    2^(idx_bits − 23) relative (the rule the port holds K3 to against JAX),
    and winners that differ only where the two rows' sums agree to that in
    f64, on at most 2% of windows."""
    ok, detail = kernel_check.k3_check(codes, luts, br, got, want)
    assert ok, detail


@pytest.mark.gpu
def test_wgmma_f32_accumulation_probe(cuda, k3_rounding):
    """The probe reads one of the known roundings; where it is to nearest,
    K3's keys on the probe equal the plain version's bit for bit."""
    print(f"wgmma f32 accumulation: {k3_rounding}")
    assert k3_rounding in ("nearest", "toward zero", "upward"), k3_rounding
    if k3_rounding == "nearest":
        u = 2.0 ** -23
        luts = torch.zeros((1, 5, 16), device=cuda)
        luts[0, :, 0] = torch.tensor([1.0, 255 / 256, 255 * 2.0 ** -16,
                                      127 * u, 0.75 * u])
        codes = torch.zeros((64, 5), dtype=torch.uint8, device=cuda)
        assert torch.equal(scan_codes.fast4_window_scan(codes, luts, 64)[0],
                           scan_codes.fast4_window_scan_ref(codes, luts, 64)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", FAST4_SHAPES)
def test_fast4_window_scan_kernel_matches_plain(cuda, k3_rounding, shape, int8):
    n, m, c, nq, br = shape
    rng = np.random.default_rng(7)
    codes = torch.as_tensor(rng.integers(0, c, (n, m)).astype(np.uint8),
                            device=cuda)
    if int8:
        luts = rng.integers(-128, 128, (nq, m, c)).astype(np.int8)
    else:   # some entries below 0, so some sums clamp at 0 and tie
        luts = (rng.random((nq, m, c)) * 4.0 - 0.1).astype(np.float32)
    luts = torch.as_tensor(luts, device=cuda)
    n_win = -(-n // br) + 1          # one window past the rows: all code 0
    kernel = "K4" if int8 else "K3"
    before = dict(scan_codes.fast4_window_scan.launches)
    s_k, i_k = scan_codes.fast4_window_scan(codes, luts, br, n_win)
    torch.cuda.synchronize()
    assert scan_codes.fast4_window_scan.launches == {
        **before, kernel: before[kernel] + 1}
    s_r, i_r = scan_codes.fast4_window_scan_ref(codes, luts, br, n_win)
    assert s_k.dtype == (torch.int32 if int8 else torch.float32)
    form = scan_codes._fast4_form(m, c, int8, nq, br).kind
    if int8 or form == "gather" or k3_rounding == "nearest":
        assert torch.equal(s_k, s_r) and torch.equal(i_k, i_r)
    else:
        assert_k3_matches(codes, luts, br, (s_k, i_k), (s_r, i_r))


# --- on mutated state --------------------------------------------------------

def poisoned_state(dtype, device, ncl=8, cap=512, d=128, seg=16, n_dead=600,
                   seed=6):
    """(IVFState, deleted ids): int8 rows of scale 32 or bf16 rows, every
    slot live with a shuffled id, then ``n_dead`` ids deleted by
    ``ivf.poison_deleted`` (id −1, poison pattern or sentinel rows)."""
    rng = np.random.default_rng(seed)
    rows, _ = make_rows(ncl * cap, d, dtype, rng)
    ids = rng.permutation(ncl * cap).astype(np.int32).reshape(ncl, cap)
    dead = rng.choice(ncl * cap, n_dead, replace=False)
    st = ivf.IVFState(
        centroids=rng.standard_normal((ncl, seg)).astype(np.float32),
        seg_dims=seg, cap=cap,
        bucket_rows=to_rows(rows, device).view(ncl, cap, d),
        bucket_ids=torch.as_tensor(ids, device=device),
        sizes=torch.full((ncl,), cap, dtype=torch.int32, device=device),
        dim_scales=(torch.full((d,), 32.0, device=device)
                    if dtype == "int8" else None))
    ivf.poison_deleted(st, torch.as_tensor(dead, device=device))
    return st, dead


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_probe_kernels_on_poisoned_buckets(cuda, dtype):
    """K5 and K7 over buckets whose deleted slots hold id −1 and poison
    rows, against their plain versions at the tolerances above; then the
    whole probe on the card against the CPU's on the same state: the same
    answers, no deleted row."""
    st, dead = poisoned_state(dtype, cuda)
    st_cpu, _ = poisoned_state(dtype, "cpu")
    assert torch.equal(st.bucket_ids.cpu(), st_cpu.bucket_ids)
    assert torch.equal(st.sizes.cpu(), st_cpu.sizes)
    assert (st.bucket_ids == -1).sum() == len(dead)
    ncl, cap, d = st.bucket_rows.shape
    gs, rng = 8, np.random.default_rng(7)
    rows = st.bucket_rows.view(ncl * cap, d)
    w = (torch.full((d,), 1.0 / 1024.0, device=cuda) if dtype == "int8"
         else torch.ones((d,), device=cuda))
    qsl = bf16_values(-2.0 * rng.standard_normal((ncl, 64, d)))
    args = (torch.as_tensor(qsl, device=cuda).to(torch.bfloat16), rows, w,
            ncl, cap, gs)
    before = probe_scan.groupmin_window_scan.launches
    got = probe_scan.groupmin_window_scan(*args)
    torch.cuda.synchronize()
    assert probe_scan.groupmin_window_scan.launches == before + 1
    rows_np = rows.float().cpu().numpy()
    assert_scores_close(got.cpu(), probe_scan.groupmin_window_scan_ref(
        *args).cpu(), groupmin_term_scale(qsl, rows_np, w.cpu().numpy(),
                                          ncl, cap, gs))
    # windows that hold poisoned slots, and others
    q = rng.standard_normal((16, d)).astype(np.float32)
    dead_blk = np.unique(np.nonzero(st_cpu.bucket_ids.numpy().reshape(-1)
                                    == -1)[0] // gs)
    wblk = np.concatenate([dead_blk[:16 * 10].reshape(16, 10),
                           rng.integers(0, ncl * cap // gs, (16, 10))],
                          axis=1).astype(np.int32)
    args = (torch.as_tensor(q, device=cuda), w, rows,
            torch.as_tensor(wblk, device=cuda), gs)
    before = rescore.gather_rescore.launches
    got = rescore.gather_rescore(*args)
    torch.cuda.synchronize()
    assert rescore.gather_rescore.launches == before + 1
    assert_scores_close(got.cpu(), rescore.gather_rescore_ref(*args).cpu(),
                        rescore_term_scale(q, w.cpu().numpy(), rows_np,
                                           wblk, gs))
    # the whole probe, card against CPU
    qp = rng.standard_normal((40, d)).astype(np.float32)
    d_g, i_g = ivf.IVFSearcher(st, 0.5).search(
        None, torch.as_tensor(qp, device=cuda), 10)
    d_c, i_c = ivf.IVFSearcher(st_cpu, 0.5).search(
        None, torch.as_tensor(qp), 10)
    i_g, i_c = i_g.cpu().numpy(), i_c.numpy()
    assert (i_g >= 0).all() and not np.isin(i_g, dead).any()
    agree = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_g, i_c)])
    assert agree >= 0.99, agree
    scale = (qp.astype(np.float64) ** 2).sum(1)[:, None] + np.abs(d_c.numpy())
    assert (np.abs(d_g.cpu().numpy() - d_c.numpy()) <= 1e-4 * scale).all()


@pytest.mark.gpu
def test_codes_kernels_after_add(cuda):
    """K1/K2 over codes that ``add`` grew to n = 5777, not a multiple of
    the window: against their plain versions, and the codes tier's answers
    on the card against the CPU's on the same state."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6000, 32)).astype(np.float32) * \
        np.linspace(2.0, 0.2, 32, dtype=np.float32)
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ64m8min8max8var1,HEAP"),
        device=cuda).build(x[:5000])
    ids = idx.add(x[5000:5777])
    assert idx.n_rows == 5777 and ids[-1] == 5776
    br = idx._codes_block_rows(2)
    assert br is not None and idx.n_rows % br != 0, br
    cents = idx.centroids
    codes = idx.codes_rowmajor()
    qp = (x[:70] + 0.1) @ idx.eigvecs[:, :idx.total_dim]
    table = scan_codes.build_decode_table(cents, cuda)
    q = torch.as_tensor(qp, device=cuda)
    before = scan_codes.decode_window_scan.launches
    s_k, i_k = scan_codes.decode_window_scan(idx.codes, table, q, br)
    torch.cuda.synchronize()
    assert scan_codes.decode_window_scan.launches == before + 1
    assert s_k.shape == (70, -(-5777 // br))
    s_r, i_r = scan_codes.decode_window_scan_ref(idx.codes, table, q, br)
    assert_windows_match(cents, codes, qp, s_k.cpu(), i_k.cpu(), s_r.cpu(),
                         i_r.cpu(), br)
    cand = torch.as_tensor(rng.integers(0, 5777, (70, 40)).astype(np.int32),
                           device=cuda)
    cand[:, -1] = 5776   # the last added row
    rows = scan_codes.build_decode_rows(cents, cuda)
    torch.testing.assert_close(
        scan_codes.decode_rescore(idx.codes, cand, rows, q),
        scan_codes.decode_rescore_ref(idx.codes, cand, rows, q),
        rtol=1e-5, atol=1e-6)
    cpu = index_from_numpy(*idx.state(), "cpu")
    d_g, i_g = idx.search(x[5000:5070], 2, backend="codes")
    d_c, i_c = cpu.search(x[5000:5070], 2, backend="codes")
    assert (i_g[:, 0] == i_c[:, 0]).mean() >= 0.97
    np.testing.assert_allclose(d_g[:, 0], d_c[:, 0], rtol=1e-4)


# (B, nq, n, W, lo, hi) for H1: W = 1, 3, 8 and 9; n not a multiple of the
# kernel's 128-row tile; nq not a multiple of its 32-query tile; B > 1 (the
# probe's cluster blocks); word ranges (the filters' sub-vectors).
H1_CASES = [(1, 5, 1000, 1, 0, None), (1, 70, 4099, 3, 0, None),
            (1, 33, 10_007, 8, 0, None), (1, 100, 777, 9, 0, None),
            (4, 40, 513, 8, 0, None), (3, 9, 300, 9, 2, 7),
            (1, 64, 2000, 8, 4, 6), (2, 1, 129, 3, 1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["xor", "jaccard"])
@pytest.mark.parametrize("case", H1_CASES)
def test_popcount_dists_kernel_matches_plain(cuda, case, op):
    """H1 bit-equal to its plain version: random words (the sign bit set
    in half of them), an all-zero row and query (an empty Jaccard union),
    an all-ones row."""
    b, nq, n, w, lo, hi = case
    rng = np.random.default_rng(n + w)
    q = rng.integers(0, 2 ** 32, (b, nq, w), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (b, n, w), dtype=np.uint32)
    q[0, 0] = 0
    x[0, 0] = 0
    x[-1, -1] = 0xFFFFFFFF
    qg = torch.as_tensor(q.view(np.int32), device=cuda)
    xg = torch.as_tensor(x.view(np.int32), device=cuda)
    before = hamming.popcount_dists.launches
    got = hamming.popcount_dists(qg, xg, op, lo, hi)
    torch.cuda.synchronize()
    assert hamming.popcount_dists.launches == before + 1
    want = hamming.popcount_dists_ref(qg, xg, op, lo, hi)
    assert got.dtype == want.dtype and got.shape == (b, nq, n)
    assert torch.equal(got, want)
    cpu = hamming.popcount_dists(qg.cpu(), xg.cpu(), op, lo, hi)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
def test_binary_searches_card_equal_cpu(cuda):
    """One BinaryIndex state searched on the card and on the CPU: packed,
    matmul, Jaccard, both filters and the cluster probe give identical ids
    and distances."""
    from vaq_tpu_torch.convert import (binary_index_from_numpy,
                                       hamming_clusters_from_numpy)
    from vaq_tpu_torch.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(6000, 64, 300, seed=11)
    gpu = binary.BinaryIndex(bit_budget=96, device=cuda).train(base)
    gpu.encode(base)
    arrays, meta = gpu.state()
    cpu = binary_index_from_numpy(arrays, meta, "cpu")
    for backend in ("packed", "matmul"):
        for a, b in zip(gpu.query(queries, 50, backend=backend),
                        cpu.query(queries, 50, backend=backend)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(gpu.query(queries, 50, metric="jaccard"),
                    cpu.query(queries, 50, metric="jaccard")):
        np.testing.assert_array_equal(a, b)
    for fn in ("query_filtering", "query_filtering_heap"):
        for q in (queries[:40], base[:40]):
            for a, b in zip(getattr(gpu, fn)(q, 10, 3),
                            getattr(cpu, fn)(q, 10, 3)):
                np.testing.assert_array_equal(a, b)
    st = binary.build_hamming_clusters(gpu, base, 24, iters=5, device=cuda)
    st_cpu = hamming_clusters_from_numpy({
        "centroids": st.centroids, "cap": st.cap,
        "bucket_words": st.bucket_words.cpu().numpy().view(np.uint32),
        "bucket_ids": st.bucket_ids.cpu().numpy(),
        "sizes": st.sizes.cpu().numpy()}, "cpu")
    for n_probe in (3, 24):
        for a, b in zip(
                binary.query_hamming_clusters(gpu, st, queries, 30, n_probe),
                binary.query_hamming_clusters(cpu, st_cpu, queries, 30,
                                              n_probe)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("method,quantize", [
    ("VAQ64m8min8max8var1,HEAP", False),     # K3's gather form (C = 256)
    ("VAQ64m16min4max4var1,FAST", True)])    # tensor-core form, K4 too
def test_kernel_parity_fields_on_a_card_index(cuda, method, quantize):
    """The package's gate on a small card index: every kernel holds, and
    each check launched its kernel (K1 at 64/32/16-row windows, K2, K3, K4
    where the LUT quantization is learned, K5 at four shapes, K7 at three,
    H1 xor and Jaccard at two, D1 at kk = 26 and 200)."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((9000, 32)) *
         np.linspace(2.0, 0.3, 32)[None, :]).astype(np.float32)
    idx = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(method),
                                 device=cuda).train(x).encode(x)
    if quantize:
        idx.learn_quantization(x, 0.1)
    counters = (scan_codes.decode_window_scan, scan_codes.decode_rescore,
                probe_scan.groupmin_window_scan, rescore.gather_rescore,
                hamming.popcount_dists, scan_decoded.decoded_topk_scan)
    before = [f.launches for f in counters]
    fast4 = dict(scan_codes.fast4_window_scan.launches)
    got = kernel_check.kernel_parity_fields(idx, x[:128] + 0.05)
    assert got["kernel_parity_ok"] is True, got
    assert got["kernel_parity_checked"] == [
        "decode_br64", "decode_br32", "decode_br16", "decode_rescore",
        "fast4"] + ["fast4_int8"] * quantize + ["groupmin", "rescore",
                                                "popcount", "decoded_topk"]
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [3, 1, 4, 3, 4, 2]
    k3 = scan_codes.fast4_window_scan.launches["K3"] - fast4["K3"]
    k4 = scan_codes.fast4_window_scan.launches["K4"] - fast4["K4"]
    assert k3 >= 1 and k4 == int(quantize)


# (case, n, d, nq, k) for D1: the benchmark cell's shape (1024 queries ×
# 1M rows × 128, k = 10); the refine fetch's and chip_smoke's k = 100 and
# 200; ties, −0/+0 scores, tombstones; n below 2k (kk = n), n not a multiple
# of the 64-row tile, one query; depths 40, 96 and 128, 57 (rows not a
# multiple of 16 bytes: the plain-load producer) and 512.
D1_CASES = [("random", 1_000_000, 128, 1024, 10),
            ("random", 1_000_000, 128, 1024, 100),
            ("random", 300_000, 128, 512, 200),
            ("random", 100_003, 96, 1000, 10),
            ("ties", 50_000, 128, 300, 10),
            ("zeros", 20_000, 40, 64, 10),
            ("tombstones", 10_000, 96, 70, 10),
            ("random", 20, 40, 3, 10),
            ("random", 777, 40, 1, 10),
            ("random", 5_000, 57, 100, 10),
            ("random", 30_000, 512, 200, 50)]


def d1_inputs(case, n, d, nq, device, seed=21):
    """bf16 rows with f32 norms and projected f32 queries on ``device``:
    ``random`` (unit normal); the others small integers, so every product
    and sum is exact and the kernel's scores equal the plain version's:
    ``ties`` (each row 8 times, and equal scores at every rank); ``zeros``
    (every fifth row zero, its norm −0 or +0 in turn); ``tombstones``
    (every third row's norm +inf)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if case == "random":
        x = torch.randn((n, d), generator=gen, device=device)
        qp = torch.randn((nq, d), generator=gen, device=device)
    else:
        x = torch.randint(-3, 4, (n, d), generator=gen, device=device).float()
        qp = torch.randint(-3, 4, (nq, d), generator=gen,
                           device=device).float()
    if case == "ties":
        x = x[torch.arange(n, device=device) // 8]
    if case == "zeros":
        x[::5] = 0.0
    rows = x.to(torch.bfloat16)
    norms = torch.sum(rows.float() ** 2, dim=1)
    if case == "zeros":
        norms[::5] = torch.where(torch.arange(0, n, 5, device=device) % 2 == 0,
                                 -0.0, 0.0)
    if case == "tombstones":
        norms[::3] = torch.inf
    return rows, norms, qp


def assert_final_match(d_a, i_a, d_b, i_b, rtol=1e-5):
    """Two exact rescores' top-k agree: distances within ``rtol``, ids as
    sets among entries strictly inside the k-th distance, −1 as often."""
    d_a, d_b = d_a.double().cpu(), d_b.double().cpu()
    i_a, i_b = i_a.cpu(), i_b.cpu()
    fin = torch.isfinite(d_b)
    assert torch.equal(torch.isfinite(d_a), fin)
    close = (d_a - d_b).abs() <= rtol * d_b.abs().clamp_min(1.0)
    assert bool(close[fin].all())
    for q in range(d_b.shape[0]):
        if not bool(fin[q].any()):
            continue
        edge = float(d_b[q][fin[q]].max())
        inside = d_b[q] < edge - rtol * max(abs(edge), 1.0)
        assert set(i_a[q][inside].tolist()) == set(i_b[q][inside].tolist()), q
        assert int((i_a[q] == -1).sum()) == int((i_b[q] == -1).sum()), q


@pytest.mark.gpu
@pytest.mark.parametrize("case", D1_CASES)
def test_decoded_topk_scan_kernel_matches_plain(cuda, case):
    """D1's merged candidates against the plain blocked scan on the card
    (``kernel_check.d1_check``), then the whole decoded tier: D1's path
    (one launch) against the plain scan with the same exact rescore."""
    kind, n, d, nq, k = case
    rows, norms, qp = d1_inputs(kind, n, d, nq, cuda)
    kk = min(max(2 * k, k + 16), n)
    q = qp.to(torch.bfloat16).contiguous()
    before = scan_decoded.decoded_topk_scan.launches
    keys = scan_decoded.decoded_topk_scan(rows, norms, q, kk)
    got = scan_decoded._lowest_split_keys(keys, kk)
    torch.cuda.synchronize()
    assert scan_decoded.decoded_topk_scan.launches == before + 1
    want = scan_decoded._scan_topk(rows, norms, q.float(), kk)
    ok, detail = kernel_check.d1_check(rows, norms, q, got, want)
    assert ok, detail
    if kind != "random":
        # integer data: every order of the sums gives the same value
        assert detail["queries_differing"] == 0 and detail["same_order"], \
            detail
    d_g, i_g = scan_decoded.decoded_scan_topk(rows, norms, qp, k)
    assert scan_decoded.decoded_topk_scan.launches == before + 2
    d_p, i_p = scan_decoded._rescore_exact(qp, rows, want, k)
    if kk < k:
        i_p = torch.nn.functional.pad(i_p, (0, k - kk), value=-1)
    assert_final_match(d_g, i_g, d_p, i_p)


# (n, d, nq, k) of 2.3 GB of bf16 rows: every row from 11,184,811 on starts
# 2^31 bytes or more into them, where 32-bit offsets would wrap; the
# deep100m-heap cell's depth, batch and k at a size a test run holds.
D1_PAST_2_31 = (12_000_037, 96, 1024, 10)


@pytest.mark.gpu
def test_decoded_topk_scan_kernel_past_2_31_bytes_of_rows(cuda):
    n, d, nq, k = D1_PAST_2_31
    rows, norms, qp = d1_inputs("random", n, d, nq, cuda)
    kk = max(2 * k, k + 16)
    q = qp.to(torch.bfloat16).contiguous()
    got = scan_decoded._lowest_split_keys(
        scan_decoded.decoded_topk_scan(rows, norms, q, kk), kk)
    want = scan_decoded._scan_topk(rows, norms, q.float(), kk)
    ok, detail = kernel_check.d1_check(rows, norms, q, got, want)
    assert ok, detail
    # the rows past 2^31 bytes are found, not only scanned
    assert int((got.to(torch.int64) * 2 * d >= 2**31).sum()) > 0


@pytest.mark.gpu
def test_decoded_topk_scan_kernel_on_an_index_after_delete(cuda):
    """The index's decoded tier on the card after ``delete``: D1 serves
    ``search(backend="decoded")`` and ``"auto"``, never returns a deleted
    row, and agrees with the CPU's plain scan on the same state."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((20_000, 64)).astype(np.float32) * \
        np.linspace(2.0, 0.3, 64, dtype=np.float32)
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ128m16min6max8var1,HEAP"),
        device=cuda).build(x)
    dead = np.arange(0, 20_000, 3)
    idx.delete(dead)
    cpu = index_from_numpy(*idx.state(), "cpu")
    before = scan_decoded.decoded_topk_scan.launches
    d_g, i_g = idx.search(x[:300] + 0.05, 10, backend="decoded")
    d_a, i_a = idx.search(x[:300] + 0.05, 10)
    assert scan_decoded.decoded_topk_scan.launches >= before + 2
    d_c, i_c = cpu.search(x[:300] + 0.05, 10, backend="decoded")
    assert not np.isin(i_g, dead).any()
    np.testing.assert_array_equal(i_a, i_g)
    assert_final_match(torch.as_tensor(d_g), torch.as_tensor(i_g),
                       torch.as_tensor(d_c), torch.as_tensor(i_c))


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 3])
def test_decoded_topk_scan_kernel_in_the_sharded_tier(cuda, n_shards):
    """The sharded decoded tier on shards of one card launches D1 once a
    shard and agrees with the same sharded search on the CPU (the plain
    scan)."""
    from vaq_tpu_torch import parallel
    from vaq_tpu_torch.parallel import dist_kmeans
    from vaq_tpu_torch.parallel.mesh import make_mesh
    rows, norms, qp = d1_inputs("random", 200_001, 128, 256, cuda)
    norms[::11] = torch.inf
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = make_mesh(devices=[dev] * n_shards)
        before = scan_decoded.decoded_topk_scan.launches
        out[dev.type] = parallel.sharded_decoded_search(
            parallel.shard_codes(rows.to(dev), mesh),
            dist_kmeans.shard_rows_for(mesh, norms.to(dev)), qp.to(dev), 10,
            rows.shape[0], mesh)
        launched = scan_decoded.decoded_topk_scan.launches - before
        assert launched == (n_shards if dev.type == "cuda" else 0)
    (d_g, i_g), (d_c, i_c) = out["cuda"], out["cpu"]
    assert not bool((i_g.cpu() % 11 == 0).any())
    assert_final_match(d_g, i_g, d_c, i_c)


@pytest.mark.gpu
def test_decoded_tier_on_the_card_runs_d1_alone(cuda, tmp_path, monkeypatch):
    """On a CUDA bf16 tier, ``decoded_scan_topk`` launches D1 once and
    reaches no ``torch.topk``, no ``lowest_over_blocks`` and no host sync;
    ``decoded.kept`` counts D1's inserts only while a profiler records, and
    its spans hold D1 (``decoded.scores``) inside ``decoded.scan``."""
    from vaq_tpu_torch import profiling

    def refuse(*args, **kw):
        raise AssertionError("the plain blocked scan ran on the card")

    monkeypatch.setattr(scan_decoded, "lowest_over_blocks", refuse)
    rows, norms, qp = d1_inputs("random", 50_000, 128, 64, cuda)
    profiling.reset_counters()
    scan_decoded.decoded_scan_topk(rows, norms, qp, 10)
    assert "decoded.kept" not in profiling.counters()
    before = scan_decoded.decoded_topk_scan.launches
    with profiling.device_trace(str(tmp_path)) as prof:
        scan_decoded.decoded_scan_topk(rows, norms, qp, 10)
    assert scan_decoded.decoded_topk_scan.launches == before + 1
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    scan = [e for e in cpu if e.name == "decoded.scan"]
    assert len(scan) == 1, [e.name for e in cpu]
    lo, hi = scan[0].time_range.start, scan[0].time_range.end
    inside = {e.name for e in cpu
              if lo <= e.time_range.start and e.time_range.end <= hi}
    assert "decoded.scores" in inside, inside
    assert not inside & {"aten::topk", "aten::item",
                         "aten::_local_scalar_dense", "cudaStreamSynchronize",
                         "cudaDeviceSynchronize"}, inside
    kept = profiling.counters()["decoded.kept"]
    assert 64 * 26 <= kept <= 64 * 50_000, kept


@pytest.mark.gpu
@pytest.mark.parametrize("nq,d,kk", [(1024, 128, 26), (1000, 128, 200),
                                     (1000, 128, 400), (64, 40, 512)])
def test_decoded_topk_scan_entry_refuses_smem_below_its_layout(cuda, nq, d,
                                                               kk):
    """The geometry's ``smem`` is exactly the kernel's own layout: D1's C
    entry launches with it and refuses one byte less, before any launch."""
    from vaq_tpu_torch import _build
    n = 4096
    rows, norms, qp = d1_inputs("random", n, d, nq, cuda)
    q = qp.to(torch.bfloat16).contiguous()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    geo = scan_decoded._d1_geometry(nq, n, d, kk, n_sm)
    lib = _build.library()
    errs = []
    for smem in (geo.smem - 1, geo.smem):
        cand = torch.empty((nq, geo.splits * kk), dtype=torch.int64,
                           device=cuda)
        bound = torch.full((nq * (1 + geo.splits),), scan_decoded._EMPTY_KEY,
                           dtype=torch.int64, device=cuda)
        errs.append(lib.vaq_decoded_topk_scan(
            rows.data_ptr(), n, d, norms.data_ptr(), q.data_ptr(), nq, kk,
            geo.mt, geo.warps, geo.stages, geo.splits, smem,
            cand.data_ptr(), bound.data_ptr(), None,
            torch.cuda.current_stream(cuda).cuda_stream))
    torch.cuda.synchronize()
    assert errs[0] != 0 and errs[1] == 0, errs
