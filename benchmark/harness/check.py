"""What decides ``correct``: the timed path's answers and the index it built,
held against the plain reference (``benchmark/reference``).

The reference judges the answers against the program's own index state (its
rotation, codebooks and codes: the ADC top-k that those define), so it
follows the program from that state. The stages this skips are judged by
themselves on the rows made again from the seed: the encode against the
program's codebooks, and the training and the clustering against a quantizer
and a clustering that the reference trains itself from the same rows, taking
no table of the program (``reference/train.py``). Each number has a limit in
``limits/<workload>.json``:

* ``dist_err``: the widest gap between a returned distance and the
  reference's ADC distance of the returned row, as a share of the query's
  k-th reference distance (an id that names no row reads ``inf``);
* ``miss``: the mean share of the reference's ADC top-k that an answer
  lacks;
* ``bad_answers``: answers with an id out of range, a repeated id, a
  distance that is not finite or not ascending;
* ``code_mismatch``: the share of a seeded sample of rows' codes that differ
  from the reference's nearest-centroid codes under the program's rotation
  and codebooks;
* ``rot_offdiag``: the largest off-diagonal entry of the training rows'
  second moments in the program's rotation, over the largest diagonal one;
* ``quant_excess``: the program's mean squared reconstruction error of the
  encode sample's rows (its codes, codebooks and rotation) over that of the
  reference's own quantizer, trained from the same training rows, less 1
  (where the allocation's rule admits two allocations, over the larger
  error of the two);
* ``cluster_excess`` (a probe): the mean squared distance of the encode
  sample's rows, in the program's rotation, to the nearest of the program's
  cluster centroids, over their distance to the nearest centroid of the
  reference's own clustering of every row (in its own rotation), less 1;
* ``bucket_far`` (a probe): the share of the encode sample's rows whose
  bucket is not among the probe's ``CANDIDATES`` nearest clusters to the
  row's reconstruction, the only buckets the probe's capacity fill may
  place it in;
* ``bad_state``: broken invariants of the built state (the bit budget and
  range, codes within their codebooks, an orthonormal rotation, every row in
  exactly one probe bucket);
* ``failed``: requests that raised or never got an answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import adc
from benchmark.reference import train as ref_train

ENCODE_SAMPLE = 65536
# the nearest clusters a row may be placed in when its own is full
CANDIDATES = 8
LIMIT_ZERO = ("bad_answers", "bad_state", "failed", "rows_remade")


def program_state(idx) -> dict:
    """The index state the reference follows, as plain tensors (copied, so
    the program can be freed first)."""
    st = {"eigvecs": torch.as_tensor(
              np.ascontiguousarray(idx.eigvecs[:, :idx.total_dim])),
          "centroids": torch.as_tensor(idx.centroids).clone(),
          "counts": torch.as_tensor(idx.centroid_counts).clone(),
          "bits": np.asarray(idx.bits).copy(),
          "budget": int(idx.config.bit_budget),
          "min_bits": int(idx.config.min_bits),
          "percent_var": float(idx.config.percent_var_explained),
          "max_bits": int(idx.config.max_bits),
          "subspaces": int(idx.config.subspace_num),
          "codes": idx.codes.clone(),
          "bucket_ids": None}
    ivf = getattr(idx, "ivf", None)
    if ivf is not None:
        st["bucket_ids"] = ivf.state.bucket_ids.clone()
        st["ivf_centroids"] = torch.as_tensor(ivf.state.centroids).clone()
    return st


def _bad_answers(ids: torch.Tensor, dists: torch.Tensor, n: int) -> int:
    bad = (ids < 0) | (ids >= n) | ~torch.isfinite(dists)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    desc = (dists[:, 1:] < dists[:, :-1]).any(dim=1)
    return int((bad.any(dim=1) | dup | desc).sum())


def _bad_state(st: dict, n: int, variances: torch.Tensor) -> dict:
    """Broken invariants of the built state, counted by kind. The bit range
    is the allocation's rule: at most ``max_bits``, and at least
    ``min_bits`` where the subspaces' cumulative share of the variance
    (``variances``, per rotated dimension) is within the configured share;
    at the share itself rounding decides, so either bound holds there."""
    bits = st["bits"]
    m = bits.shape[0]
    share = variances.reshape(m, -1).sum(dim=1).cumsum(0) / variances.sum()
    lb = np.where(share.cpu().numpy() < st["percent_var"] - 1e-6,
                  st["min_bits"], 0)
    bad = {"bit_budget": int(bits.sum() != st["budget"]),
           "bit_range": int(((bits < lb) | (bits > st["max_bits"])).sum())}
    codes = st["codes"]
    counts = st["counts"].to(codes.device)
    bad["code_range"] = int((codes.to(torch.int64) >= counts[None, :])
                            .any(dim=1).sum())
    e = st["eigvecs"].to(torch.float64)
    bad["rotation"] = int((e.T @ e - torch.eye(
        e.shape[1], dtype=torch.float64, device=e.device)).abs().max() > 1e-4)
    if st["bucket_ids"] is not None:
        ids = st["bucket_ids"].reshape(-1)
        ids = ids[ids >= 0].to(torch.int64)
        seen = torch.bincount(ids, minlength=n)[:n]
        bad["rows_not_in_one_bucket"] = int((seen != 1).sum()) + \
            int((ids >= n).sum())
    return bad


@torch.no_grad()
def numbers(st: dict, answers: dict, base: torch.Tensor,
            queries: torch.Tensor, train_ids, seed: int, k: int,
            probe: dict | None = None, control: dict | None = None
            ) -> tuple:
    """(the numbers compared, what is printed beside them) for the sampled
    ``answers`` (``q_index`` (S,), ``ids`` (S, k), ``dists`` (S, k) host
    arrays, ``failed``) against rows ``base``/``queries`` made again;
    ``probe`` is the configuration's probe (``clusters``, ``segments``).

    ``control`` (a control run's spec) puts the reference, computed in TF32
    products, in the program's place: always for the encode, and for the
    answers where it says ``"answers": "reference_tf32"`` (or, below bf16,
    ``"reference_fp8"``)."""
    dev = base.device
    n = base.shape[0]
    codes = st["codes"].to(dev)
    cent = st["centroids"].to(dev)
    e = st["eigvecs"].to(dev)
    out = {"failed": int(answers["failed"])}
    info = {"answers_checked": int(len(answers["q_index"]))}
    ids = torch.as_tensor(answers["ids"], device=dev).to(torch.int64)
    dists = torch.as_tensor(answers["dists"], device=dev).to(torch.float64)
    if ids.shape[0]:
        q = queries[torch.as_tensor(answers["q_index"], device=dev)]
        if control and control.get("answers") == "reference_tf32":
            with adc.tf32():
                cd, ci = adc.adc_topk_f32(q, e, codes, cent, k)
            dists, ids = cd.to(torch.float64), ci
        elif control and control.get("answers") == "reference_fp8":
            cd, ci = adc.adc_topk_f32(q, e, codes, cent, k, fp8=True)
            dists, ids = cd.to(torch.float64), ci
        q_rot = adc.rotate(q, e)
        ref_d, ref_i = adc.adc_topk(q_rot, codes, cent, k)
        got = adc.adc_dists(q_rot, codes, ids, cent)
        dk = torch.clamp_min(ref_d[:, -1], 1e-30)
        gap = torch.nan_to_num((dists - got).abs() / dk[:, None],
                               nan=math.inf)
        out["dist_err"] = float(gap.max())
        hit = (ids[:, :, None] == ref_i[:, None, :]).any(dim=2)
        out["miss"] = float(1.0 - hit.to(torch.float64).mean())
        out["bad_answers"] = _bad_answers(ids, dists, n)
        _, true_i = adc.exact_topk(q, base, k)
        info["recall_at_k"] = float(
            (ids[:, :, None] == true_i[:, None, :]).any(dim=2)
            .to(torch.float64).mean())
        info["adc_recall_ceiling"] = float(
            (ref_i[:, :, None] == true_i[:, None, :]).any(dim=2)
            .to(torch.float64).mean())
    else:
        out["dist_err"] = math.inf
        out["miss"] = 1.0
        out["bad_answers"] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 2654435761 + 7) % (1 << 63))
    sample = torch.randperm(n, generator=gen, device=dev)[:ENCODE_SAMPLE]
    ref_codes = adc.encode(adc.rotate(base[sample], e), cent,
                           st["counts"].to(dev))
    got_codes = codes[sample].to(torch.int64)
    if control is not None:
        with adc.tf32():
            got_codes = adc.encode_f32(base[sample], e, cent,
                                       st["counts"].to(dev))
    out["code_mismatch"] = float(
        (ref_codes != got_codes).to(torch.float64).mean())
    train = base if train_ids is None else base[train_ids.to(dev)]
    out["rot_offdiag"], variances = adc.rotation_moments(train, e)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 2654435761 + 11) % (1 << 63))
    ref_qs = ref_train.quantizers(train, st["subspaces"], st["budget"],
                                  st["min_bits"], st["max_bits"],
                                  st["percent_var"], gen)
    del train
    rows = base[sample]
    prog_err = ref_train.program_recon_error(rows, e, got_codes, cent)
    ref_errs = [ref_train.recon_error(rows, q) for q in ref_qs]
    out["quant_excess"] = prog_err / max(ref_errs) - 1.0
    info["recon_error"] = {
        "program": prog_err, "reference": ref_errs,
        "reference_bits": [[int(b) for b in q["bits"]] for q in ref_qs]}
    if probe and st["bucket_ids"] is not None:
        nums, info["clusters"] = _clusters(st, base, sample, ref_qs[0],
                                           probe, gen)
        out.update(nums)
    bad = _bad_state({**st, "codes": codes}, n, variances)
    info["bits"] = [int(b) for b in st["bits"]]
    out["bad_state"] = sum(bad.values())
    info["bad_state_by_kind"] = bad
    return out, info


def _clusters(st: dict, base: torch.Tensor, sample: torch.Tensor,
              ref_q: dict, probe: dict, gen: torch.Generator) -> tuple:
    """(``cluster_excess`` and ``bucket_far``, what is printed beside them):
    the program's cluster centroids against a clustering the reference fits
    itself to every row's prefix of ``probe["segments"]`` subspaces, and
    the program's buckets against the nearest clusters to each row."""
    dev = base.device
    n = base.shape[0]
    cents = st["ivf_centroids"].to(device=dev, dtype=torch.float64)
    seg = cents.shape[1]
    bids = st["bucket_ids"].to(dev)
    owner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    live = bids >= 0
    cl = torch.arange(bids.shape[0], device=dev)[:, None].expand_as(bids)
    owner[bids[live].to(torch.int64)] = cl[live]
    rows = base[sample]
    e = st["eigvecs"].to(device=dev, dtype=torch.float64)
    prog_p = ref_train.pad_cols(rows.to(torch.float64), e.shape[0]) \
        @ e[:, :seg]
    prog = ref_train.nearest_error(prog_p, cents)
    seg_ref = int(probe["segments"]) * ref_q["sub_len"]
    e_ref = ref_q["eigvecs"][:, :seg_ref].to(torch.float32)
    fit = torch.cat([ref_train.pad_cols(base[s:s + (1 << 20)], e.shape[0])
                     @ e_ref for s in range(0, n, 1 << 20)])
    ref_c = ref_train.kmeans(fit, int(probe["clusters"]), gen)
    ref = ref_train.nearest_error(fit[sample], ref_c)
    del fit
    mine = owner[sample]
    recon = adc.reconstruct(st["codes"].to(dev)[sample], st["centroids"]
                            .to(dev))[:, :seg]
    rank = ref_train.nearest_ranks(recon, cents, torch.clamp_min(mine, 0))
    far = (mine < 0) | (rank >= CANDIDATES)
    nums = {"cluster_excess": prog / ref - 1.0,
            "bucket_far": float(far.to(torch.float64).mean())}
    return nums, {"program_sq_dist": prog, "reference_sq_dist": ref,
                  "not_in_nearest": float((rank > 0).to(torch.float64)
                                          .mean())}


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number above its limit, or not a number, fails."""
    table = {}
    ok = True
    for name, value in nums.items():
        limit = 0 if name in LIMIT_ZERO else limits["limits"][name]
        table[name] = {"value": value, "limit": limit}
        if not (value <= limit):
            ok = False
    return ok, table
