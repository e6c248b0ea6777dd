"""The port's on-card kernel gate (``vaq_tpu_torch/ops/kernel_check.py``) on
the CPU, where no kernel runs.

``groupmin_ref64_and_bound`` is a copy of JAX's and must equal it bit for
bit. ``kernel_parity_fields`` on a CPU index reports what JAX's reports on
its CPU backend. The gate's logic is tested with fake kernels in place of
the CUDA ones: each ``_parity_*`` helper accepts a "kernel" that returns
the plain version's output moved by half its tolerance, and rejects one that
moves it by twice its tolerance or that returns another row as a window's
winner where the two rows do not tie. The kernels themselves are held to
the gate on the card by ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from vaq_tpu.ops import kernel_check as jkc
from vaq_tpu_torch.ops import kernel_check as kc
from vaq_tpu_torch.ops import (hamming, probe_scan, rescore, scan_codes,
                               scan_decoded)

torch.set_num_threads(2)  # six test workers share the host


def _rows64(rows):
    return np.asarray(rows, np.float64)


@pytest.mark.parametrize("ncl,cap,gs,qcap,d,dtype", [
    (3, 512, 8, 40, 128, "int8"), (2, 1024, 128, 16, 96, "int8"),
    (2, 256, 16, 33, 64, "bf16")])
def test_groupmin_ref64_and_bound_equals_jax(ncl, cap, gs, qcap, d, dtype):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((ncl * cap, d)).astype(np.float32)
    if dtype == "int8":
        rows64 = _rows64(np.clip(np.round(rows * 32.0), -127, 127))
        w = np.full((d,), 1.0 / 1024.0, np.float32)
    else:
        rows64 = _rows64(torch.as_tensor(rows).to(torch.bfloat16).double())
        w = np.ones((d,), np.float32)
    qsl = torch.as_tensor(-2.0 * rng.standard_normal((ncl, qcap, d))).to(
        torch.bfloat16).double().numpy()
    got = kc.groupmin_ref64_and_bound(qsl, rows64, w, ncl, cap, gs)
    want = jkc.groupmin_ref64_and_bound(qsl, rows64, w, ncl, cap, gs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        assert np.array_equal(a, b)
    assert got[0].shape == (ncl, cap // gs, qcap) and (got[1] > 0).all()


def test_cpu_index_reports_no_parity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ32m4min8max8var1,HEAP"),
        device="cpu").train(x).encode(x)
    got = kc.kernel_parity_fields(idx, x[:8])
    assert got["kernel_parity_ok"] is None
    assert "cpu" in got["kernel_parity_note"]
    jidx = vaq_tpu.VAQIndex(
        vaq_tpu.parse_method_string("VAQ32m4min8max8var1,HEAP")).train(x)
    want = jkc.kernel_parity_fields(jidx.encode(x), x[:8])
    assert set(got) == set(want) and want["kernel_parity_ok"] is None


# --- fake kernels -----------------------------------------------------------

def k1_inputs(m=8, c=64, l=4, n=4096, nq=12, seed=3):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, c, (n, m)).astype(np.uint8))
    qp = torch.as_tensor(rng.standard_normal((nq, m * l)).astype(np.float32))
    return codes, scan_codes.build_decode_table(cents, "cpu"), qp


def moved(out, tol, factor):
    """``out`` plus ``factor`` times the tolerance ``tol``."""
    return (out.double() + factor * tol).to(out.dtype)


def swap_winner(ids, block_rows, score_of):
    """``ids`` with window (0, 0)'s winner replaced by a row of the same
    window that does not tie with it (``score_of(rows)`` gives query 0's
    scores)."""
    out = ids.clone()
    win = torch.arange(block_rows) + (int(ids[0, 0]) // block_rows) * block_rows
    s = score_of(win)
    other = win[torch.argmax((s - s[win == ids[0, 0]]).abs())]
    out[0, 0] = other
    return out


@pytest.mark.parametrize("br", [64, 32, 16])
def test_k1_gate_accepts_half_and_rejects_twice_its_tolerance(br):
    codes, table, qp = k1_inputs()
    s_r, i_r = scan_codes.decode_window_scan_ref(codes, table, qp, br)
    tol = kc.ATOL + kc.k1_rtol(br) * kc.k1_terms(codes, table, qp, i_r)

    def fake(factor, ids=None):
        return lambda *a: (moved(s_r, tol, factor), i_r if ids is None else ids)

    for factor in (0.5, -0.5):
        ok, detail = kc._parity_k1(codes, table, qp, br, fake(factor))
        assert ok and 0.4 < detail["max_err_over_tol"] < 0.6, detail
    ok, detail = kc._parity_k1(codes, table, qp, br, fake(2.0))
    assert not ok and detail["max_err_over_tol"] > 1.5
    swapped = swap_winner(i_r, br, lambda rows: kc.k1_scores64(
        codes, table, qp, torch.zeros_like(rows), rows))
    ok, detail = kc._parity_k1(codes, table, qp, br, fake(0.0, swapped))
    assert not ok and not detail["ties_ok"] and detail["id_mismatches"] == 1


def test_k1_gate_holds_winners_to_ties_on_duplicate_rows():
    """Rows with the same codes tie exactly: a kernel may return either."""
    codes, table, qp = k1_inputs()
    r = int(scan_codes.decode_window_scan_ref(codes, table, qp, 64)[1][0, 0])
    p = r + 1 if r % 64 != 63 else r - 1        # a row of the same window
    codes[p] = codes[r]
    s_r, i_r = scan_codes.decode_window_scan_ref(codes, table, qp, 64)
    assert int(i_r[0, 0]) == min(r, p)          # ties go to the lower row
    ids = i_r.clone()
    ids[0, 0] = max(r, p)
    ok, detail = kc._parity_k1(codes, table, qp, 64, lambda *a: (s_r, ids))
    assert ok and detail["id_mismatches"] == 1


def test_k2_gate_accepts_half_and_rejects_twice_its_tolerance():
    codes, _, qp = k1_inputs()
    rows = scan_codes.build_decode_rows(
        np.random.default_rng(3).standard_normal((8, 64, 4)).astype(np.float32),
        "cpu")
    cand = torch.as_tensor(np.random.default_rng(1).integers(
        0, 4096, (12, 50)).astype(np.int32))
    cand[:, -2:] = torch.tensor([-1, 4096], dtype=torch.int32)
    ref = scan_codes.decode_rescore_ref(codes, cand, rows, qp)
    tol = kc.ATOL + kc.TERMS_RTOL * ref.double().abs()
    assert kc._parity_k2(codes, cand, rows, qp, lambda *a: moved(ref, tol, 0.5))[0]
    assert not kc._parity_k2(codes, cand, rows, qp,
                             lambda *a: moved(ref, tol, 2.0))[0]
    finite = ref.clone()
    finite[:, -1] = 1.0                       # an id past n that scored
    assert not kc._parity_k2(codes, cand, rows, qp, lambda *a: finite)[0]


def fast4_inputs(m, c, int8, nq=9, n=5000, seed=5):
    rng = np.random.default_rng(seed)
    codes = torch.as_tensor(rng.integers(0, c, (n, m)).astype(np.uint8))
    luts = (torch.as_tensor(rng.integers(-128, 128, (nq, m, c)).astype(np.int8))
            if int8 else
            torch.as_tensor((rng.random((nq, m, c)) * 4.0).astype(np.float32)))
    return codes, luts


@pytest.mark.parametrize("m,c,int8,rounding", [
    (32, 256, False, "toward zero"),     # the gather form: keys equal
    (64, 16, False, "nearest"),          # tensor cores adding to nearest
    (64, 16, True, "toward zero"),       # K4: keys equal in either form
    (32, 256, True, "nearest")])
def test_fast4_gate_wants_equal_keys(m, c, int8, rounding):
    codes, luts = fast4_inputs(m, c, int8)
    want = scan_codes.fast4_window_scan_ref(codes, luts, 64)
    assert kc._parity_fast4(codes, luts, 64, rounding, lambda *a: want) == \
        (True, {"form": scan_codes._fast4_form(m, c, int8, 9, 64).kind,
                "mismatches": 0})
    s, i = want
    bumped = s.clone()
    bumped[3, 5] += 1 if int8 else float(s[3, 5]) * 2.0 ** -20
    ok, detail = kc._parity_fast4(codes, luts, 64, rounding,
                                  lambda *a: (bumped, i))
    assert not ok and detail["mismatches"] == 1
    ids = i.clone()
    ids[0, 0] += 1
    assert not kc._parity_fast4(codes, luts, 64, rounding,
                                lambda *a: (s, ids))[0]


def test_k3_tensor_core_gate_accepts_half_and_rejects_twice():
    """K3's tensor-core form where the card truncates: K1's rule relative
    to the score."""
    codes, luts = fast4_inputs(64, 16, False)
    assert scan_codes._fast4_form(64, 16, False, 9, 64).kind == "mma"
    s_r, i_r = scan_codes.fast4_window_scan_ref(codes, luts, 64)
    tol = kc.ATOL + kc.k1_rtol(64) * s_r.double().abs()
    for factor, want in ((0.5, True), (-0.5, True), (2.0, False)):
        ok, detail = kc._parity_fast4(
            codes, luts, 64, "toward zero",
            lambda *a: (moved(s_r, tol, factor), i_r))
        assert ok == want and detail["form"] == "mma", (factor, detail)
    swapped = swap_winner(i_r, 64, lambda rows: kc.k3_sums64(
        codes, luts, torch.zeros_like(rows), rows))
    ok, detail = kc._parity_fast4(codes, luts, 64, "toward zero",
                                  lambda *a: (s_r, swapped))
    assert not ok and not detail["ties_ok"]


SMALL_GROUPMIN = {"int8": (3, 512, 8, 40, 128, "int8"),
                  "d96": (2, 1024, 16, 24, 96, "int8"),
                  "bf16": (2, 512, 64, 20, 128, "bf16")}


def groupmin_tol(qsl, rows, w, ncl, cap, gs):
    """The tighter of the gate's two K5 tolerances, per output, in K5's
    (ncl, qcap, ng) layout."""
    _, bound = kc.groupmin_ref64_and_bound(
        qsl.double().numpy(), rows.double().numpy(), w.numpy(), ncl, cap, gs)
    jax_limit = torch.as_tensor(4.0 * np.maximum(bound, 1e-12)).transpose(1, 2)
    terms = kc.TERMS_RTOL * kc.groupmin_term_scale(qsl, rows, w, ncl, cap, gs)
    return torch.minimum(jax_limit, terms)


def test_groupmin_gate_passes_the_plain_version_at_jax_shapes():
    ok, detail = kc._parity_groupmin("cpu", probe_scan.groupmin_window_scan)
    assert ok and detail == {}


@pytest.mark.parametrize("factor,want", [(0.5, True), (-0.5, True),
                                         (2.0, False), (-2.0, False)])
def test_groupmin_gate_accepts_half_and_rejects_twice(factor, want):
    def fake(*args):
        return moved(probe_scan.groupmin_window_scan_ref(*args),
                     groupmin_tol(*args), factor)

    ok, detail = kc._parity_groupmin("cpu", fake, SMALL_GROUPMIN)
    assert ok == want, detail
    if not want:                                # every shape fails
        assert {k.split("_")[0] for k in detail} == set(SMALL_GROUPMIN)


SMALL_RESCORE = {"int8": (6, 5, 16, 128, 20, "int8"),
                 "bf16": (4, 7, 32, 128, 9, "bf16"),
                 "d96": (3, 4, 128, 96, 6, "int8")}


@pytest.mark.parametrize("factor,want", [(0.5, True), (-0.5, True),
                                         (2.0, False)])
def test_gather_rescore_gate_accepts_half_and_rejects_twice(factor, want):
    def fake(*args):
        ref = rescore.gather_rescore_ref(*args)
        tol = torch.minimum(2e-4 * ref.double().abs().clamp_min(1.0),
                            kc.TERMS_RTOL * kc.rescore_term_scale(*args))
        return moved(ref, tol, factor)

    ok, detail = kc._parity_gather_rescore("cpu", fake, shapes=SMALL_RESCORE)
    assert ok == want, detail
    if not want:
        assert set(detail) == set(SMALL_RESCORE)


def test_gather_rescore_gate_passes_the_plain_version_at_jax_shapes():
    assert kc._parity_gather_rescore("cpu", rescore.gather_rescore) == \
        (True, {})


def test_popcount_gate_wants_equal_counts():
    shapes = {"flat": (1, 8, 300, 8), "blocks": (3, 5, 40, 2)}
    assert kc._parity_popcount("cpu", hamming.popcount_dists, shapes) == \
        (True, {})

    def off_by_one(q, x, op):
        out = hamming.popcount_dists_ref(q, x, op).clone()
        out[0, 0, 0] = out[0, 0, 0] + (1 if op == "xor" else 2.0 ** -20)
        return out

    ok, detail = kc._parity_popcount("cpu", off_by_one, shapes)
    assert not ok and set(detail) == {"flat_xor", "flat_jaccard",
                                      "blocks_xor", "blocks_jaccard"}
    assert all(v == {"mismatches": 1} for v in detail.values())


@pytest.mark.parametrize("method,quantize", [
    ("VAQ64m8min8max8var1,HEAP", False), ("VAQ64m16min4max4var1,FAST", True)])
def test_gate_path_runs_every_check_on_a_cpu_index(method, quantize,
                                                   monkeypatch):
    """The gate's checks on a CPU index, where the wrappers take their plain
    versions on both sides: the slices, tables, LUTs and seeded shapes the
    card sees (H1's cut: its plain version takes 20 s on the CPU at the
    card's), every check passing, K4 only with a learned quantization."""
    monkeypatch.setattr(kc, "POPCOUNT_SHAPES", {"flat": (1, 16, 2048, 8),
                                                "blocks": (4, 8, 500, 8)})
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((5000, 32)) *
         np.linspace(2.0, 0.3, 32)[None, :]).astype(np.float32)
    idx = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(method),
                                 device="cpu").train(x).encode(x)
    if quantize:
        idx.learn_quantization(x, 0.1)
    checks = kc._checks(idx, x[:40] + 0.05, 65536, 32)
    assert list(checks) == [
        "decode_br64", "decode_br32", "decode_br16", "decode_rescore",
        "fast4"] + ["fast4_int8"] * quantize + ["groupmin", "rescore",
                                                "popcount", "decoded_topk"]
    assert all(ok for ok, _ in checks.values()), checks
    assert checks["fast4"][1]["form"] == ("mma" if quantize else "gather")
    assert checks["decode_br16"][1]["max_err_over_tol"] == 0.0


def d1_inputs(n=3000, d=64, nq=10, seed=5):
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)
                           ).to(torch.bfloat16)
    norms = torch.sum(rows.float() ** 2, dim=1)
    norms[::97] = torch.inf                  # tombstones
    qp = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    return rows, norms, qp


def test_d1_gate_passes_the_plain_version_and_near_ties():
    """D1's gate on its plain version; and on a fake kernel whose kk-th
    candidate is swapped for a row the plain version ranks next, moved
    within the tolerance of it (a boundary tie on the tensor cores)."""
    rows, norms, qp = d1_inputs()
    ok, detail = kc._parity_d1(rows, norms, qp)
    assert ok and detail["kk26"]["queries_differing"] == 0, detail
    q = qp.to(torch.bfloat16).contiguous()
    want = scan_decoded._scan_topk(rows, norms, q.float(), 27)
    s, t = kc.d1_scores64(rows, norms, q, want)
    got = want[:, :26].clone()
    got[0, 25] = want[0, 26]
    # the swap is legal only if row 27 scores within tolerance of row 26
    gap = float((s[0, 26] - s[0, 25]) / (kc.TERMS_RTOL * (t[0, 26] + t[0, 25])
                                         + kc.ATOL))
    ok, detail = kc.d1_check(rows, norms, q, got, want[:, :26])
    assert detail["queries_differing"] == 1
    assert ok == (gap <= 1.0)
    assert detail["max_excess_over_tol"] == pytest.approx(gap)


def test_d1_gate_rejects_a_lost_winner_and_a_tombstone():
    """A fake D1 that drops a query's best row for its 27th, or that
    returns a tombstoned row, fails the gate."""
    rows, norms, qp = d1_inputs()
    q = qp.to(torch.bfloat16).contiguous()
    want = scan_decoded._scan_topk(rows, norms, q.float(), 27)

    def lost_winner(r, nrm, qq, kk):
        keys = scan_decoded.decoded_topk_scan(r, nrm, qq, kk)
        if kk == 26:
            keys = keys.clone()
            lo = torch.sort(keys[3]).values
            keys[3][keys[3] == lo[0]] = int(
                (lo[0] & ~0xFFFFFFFF) | int(want[3, 26]))
        return keys

    ok, detail = kc._parity_d1(rows, norms, qp, kernel=lost_winner)
    assert not ok and detail["kk26"]["queries_differing"] == 1
    assert detail["kk26"]["max_excess_over_tol"] > 1.0
    dead = want[:, :26].clone()
    dead[1, 0] = 97                          # a tombstone (+inf norm)
    ok, detail = kc.d1_check(rows, norms, q, dead, want[:, :26])
    assert not ok
