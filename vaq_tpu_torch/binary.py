"""Binary/Hamming bit-vector engine — the BitVecEngine, in PyTorch.

The counterpart of ``vaq_tpu/binary.py`` (reference
``bitvecengine/BitVecEngine.{hpp,cpp}`` + ``BitVector.hpp``), every public
name with JAX's signature plus a ``device``:

* **Representation** (B1): packed bits in 32-bit words, bit j of the budget
  in word j // 32 at its MSB-first offset (``encodeToBinary``,
  BitVecEngine.hpp:564-588). On the host they are JAX's uint32; on the
  device the same bits viewed as int32 (torch has no uint32 arithmetic;
  XOR and popcount do not care about the sign).
* **Scalar quantizer** (B3): training and encoding stay host numpy, as in
  JAX (binary.py:190-271): the f32 XᵀX, the f64 ``eigh``, the per-dimension
  bit allocation (``bitalloc.allocate_bits_per_dim``), the matlab-style
  quantile boundaries and ``searchsorted``. The same code gives bit-equal
  rotations, bits, boundaries and packed codes. Only the searched state
  lives on the device: ``packed`` (n, W) int32, ``db01`` (n, total_bits)
  int8 0/1 and ``db_pop`` (n,) int32.
* **Hamming search** (B5), two backends as in JAX:
  - ``packed``: XOR + popcount + word sum by kernel H1
    (``ops/hamming.py``, ``csrc/hamming_scan.cu``) in row blocks;
  - ``matmul``: ``pop(q) + pop(x) − 2·(q01 · x01ᵀ)`` by ``torch._int_mm``
    (int8 in, int32 out: exact) in row blocks. JAX's ``matmul`` defaults to
    ``approx_max_k``; the port's top-k is always exact (JAX's
    ``exact=True``).
  Both keep the k lowest by (distance, id), as JAX's running merge does.
* **Rerank** (B7), exact scans (``query_naive``, L2 or Manhattan), the
  progressive filters (B10, queries in batches, since each query's answer
  is its own), the disk-resident streaming scan (B9), CRUD and the
  cluster-pruned Hamming probe (B6) over ``ops/probe``'s dispatch.

Every entry point runs on ``"cuda"`` unless given ``device="cpu"`` and
raises ``DeviceError`` without a card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vaq_tpu_torch import bitalloc, io, kmeans, native
from vaq_tpu_torch.device import DEFAULT, resolve
from vaq_tpu_torch.ops import distances, hamming
from vaq_tpu_torch.ops import probe as probe_ops
from vaq_tpu_torch.ops.scan_codes import _select_lowest
from vaq_tpu_torch.ops.scan_lut import refine_topk
from vaq_tpu_torch.rng import DEFAULT_SEED

WORD = 32
# JAX's integer "no candidate" distance (binary.py:124, 138, 752).
FAR = 2 ** 30
# Rows per block of the packed and matmul scans (JAX binary.py:105): a block
# of 1000 queries' int32 distances is 262 MB.
BLOCK_ROWS = 65536
# Elements of the (stages, queries, rows) int32 stack a filtering batch of
# queries holds at most (JAX builds it whole: 16 GB at 1000 × 1M × 4).
FILTER_ELEMS = 1 << 28
# Elements of one cluster block's (cb, qcap, cap) scores (JAX binary.py:775).
PROBE_BLOCK_ELEMS = 1 << 23


# ---------------------------------------------------------------------------
# Bit packing (B1)
# ---------------------------------------------------------------------------

def pack_codes(buckets: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Pack per-dim bucket indices into uint32 words, MSB-first.

    buckets: (n, d) ints with buckets[:, j] < 2^bits[j]; bits: (d,).
    Returns (n, ceil(sum(bits)/32)) uint32 — the native packer where it
    built, else JAX's numpy loop (binary.py:50-84)."""
    bits = np.asarray(bits, dtype=np.int64)
    packed = native.pack_codes(buckets, bits)
    if packed is not None:
        return packed
    total = int(bits.sum())
    nwords = (total + WORD - 1) // WORD
    n = buckets.shape[0]
    out = np.zeros((n, nwords), dtype=np.uint64)  # u64 scratch avoids UB
    pos = np.concatenate([[0], np.cumsum(bits)])
    for j in range(buckets.shape[1]):
        b = int(bits[j])
        if b == 0:
            continue
        start = int(pos[j])
        val = buckets[:, j].astype(np.uint64)
        w0, w1 = start // WORD, (start + b - 1) // WORD
        if w0 == w1:
            shift = WORD - (start % WORD) - b
            out[:, w0] |= val << np.uint64(shift)
        else:  # straddles a word boundary (hpp:573-578)
            right = b - ((w0 + 1) * WORD - start)
            out[:, w0] |= val >> np.uint64(right)
            out[:, w1] |= (val & np.uint64((1 << right) - 1)) << np.uint64(
                WORD - right)
        out[:, w0] &= np.uint64(0xFFFFFFFF)
        if w1 < nwords:
            out[:, w1] &= np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32)


def unpack_bits_01(packed: np.ndarray, total_bits: int) -> np.ndarray:
    """(n, W) uint32 → (n, total_bits) int8 0/1 matrix (MSB-first order)."""
    n, w = packed.shape
    shifts = np.arange(WORD - 1, -1, -1, dtype=np.uint32)
    bits = ((packed[:, :, None] >> shifts[None, None, :]) & 1).astype(np.int8)
    return bits.reshape(n, w * WORD)[:, :total_bits]


def _unpack_words(words: torch.Tensor, total_bits: int) -> torch.Tensor:
    """:func:`unpack_bits_01` of int32 words, on their device. Bit s of a
    word is ``(word >> s) & 1`` whatever the arithmetic shift fills in."""
    shifts = torch.arange(WORD - 1, -1, -1, dtype=torch.int32,
                          device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).to(torch.int8)
    return bits.reshape(words.shape[0], -1)[:, :total_bits].contiguous()


def _device_words(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words (any shape) on ``device`` as int32: the bits viewed,
    not converted."""
    words = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return torch.tensor(words, device=device)


# ---------------------------------------------------------------------------
# Hamming scans (B5)
# ---------------------------------------------------------------------------

def hamming_topk_packed(db: torch.Tensor, queries: torch.Tensor, k: int,
                        exact: bool = True, block_rows: int = BLOCK_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """XOR + popcount + word sum (H1) + top-k, in row blocks (JAX
    binary.py:99-142; the reference's query_sort/query_heap).

    db (n, W) and queries (nq, W) int32 words on one device. Returns
    (dists (nq, k) int32 ascending, ids (nq, k) int32), ties to the lower
    id, (2^30, −1) past n. ``exact`` is kept for JAX's signature: the
    port's top-k is always exact."""
    n = db.shape[0]
    block_rows = min(block_rows, max(n, 1))
    q = queries[None].contiguous()

    def blocks():
        for start in range(0, n, block_rows):
            yield hamming.popcount_dists(
                q, db[None, start:start + block_rows])[0], start

    return distances.running_lowest(blocks, k, FAR)


def hamming_topk_matmul(db01: torch.Tensor, db_pop: torch.Tensor,
                        q01: torch.Tensor, k: int, exact: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hamming = pop(q) + pop(x) − 2·(q01 · x01ᵀ)`` (JAX binary.py:145-163)
    by ``torch._int_mm`` (int8 × int8 → int32, exact), a row block at a
    time (JAX forms the whole (nq, n) matrix).

    db01 (n, B) and q01 (nq, B) int8 0/1, db_pop (n,) int32. Returns (dists
    (nq, k) int32 ascending, ids (nq, k) int32), ties to the lower id: JAX's
    ``exact=True`` answer, which the port gives whatever ``exact`` says."""
    n, nbits = db01.shape
    nq = q01.shape[0]
    block_rows = min(BLOCK_ROWS, max(n, 1))
    q_pop = q01.sum(1, dtype=torch.int32)
    # _int_mm takes more than 16 rows and a multiple of 8 in the other axes
    pad_b = (-nbits) % 8
    q = torch.nn.functional.pad(q01, (0, pad_b, 0, max(0, 17 - nq)))

    def blocks():
        for start in range(0, n, block_rows):
            blk = db01[start:start + block_rows]
            rows = blk.shape[0]
            blk = torch.nn.functional.pad(blk, (0, pad_b, 0, (-rows) % 8))
            inner = torch._int_mm(q, blk.T)[:nq, :rows]
            yield (q_pop[:, None] + db_pop[None, start:start + rows]
                   - 2 * inner), start

    return distances.running_lowest(blocks, k, FAR)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BinaryIndex:
    """Scalar-quantized binary index (binaryEncoding pipeline) on one torch
    device."""

    bit_budget: int
    seed: int = DEFAULT_SEED
    device: torch.device | str = DEFAULT

    eigvecs: Optional[np.ndarray] = None      # (d, d) f32
    bits: Optional[np.ndarray] = None         # (d,) per-dim bit allocation
    boundaries: Optional[np.ndarray] = None   # (256, d) quantile boundaries
    total_bits: int = 0
    orig_dim: int = 0

    packed: Optional[torch.Tensor] = None     # (n, W) int32 (uint32 bits)
    n_rows: int = 0
    # matmul backend state
    db01: Optional[torch.Tensor] = None       # (n, B) int8
    db_pop: Optional[torch.Tensor] = None     # (n,) int32

    def __post_init__(self):
        self.device = resolve(self.device)

    # ------------------------------------------------------------------
    def train_simple(self, x_train: np.ndarray) -> "BinaryIndex":
        """Sign-bit encoder (binaryEncodingSimple, BitVecEngine.hpp:190-274):
        PCA-project, 1 bit per leading dimension (sign), no bit allocation."""
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = d = x_train.shape[1]
        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        self.eigvecs = evecs[:, order].astype(np.float32)
        nbits = min(self.bit_budget, d)
        self.bits = np.zeros(d, dtype=np.int64)
        self.bits[:nbits] = 1
        # boundary 0 per used dim → bucket = sign bit
        self.boundaries = np.full((256, d), np.finfo(np.float32).max,
                                  dtype=np.float32)
        self.boundaries[0, :nbits] = 0.0
        self.total_bits = nbits
        return self

    def train(self, x_train: np.ndarray, verbose: bool = False) -> "BinaryIndex":
        """PCA, per-dimension bit allocation and quantile boundaries
        (binaryEncoding, BitVecEngine.hpp:278-561; JAX binary.py:209-240)."""
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = d = x_train.shape[1]

        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        evals, evecs = evals[order], evecs[:, order]
        self.eigvecs = evecs.astype(np.float32)

        var = evals / evals.sum()
        # clamp rule of hpp:333-337: tiny variances get an even tinier floor
        var = np.where(var < 1e-11, 1e-17, var)

        b = self.bit_budget
        cum = np.cumsum(var)
        uniform_var = cum[min(b, d) - 1]
        thresh = 0.99 * uniform_var
        lb = np.zeros(d, dtype=np.int64)
        lb[: min(b, d)] = (thresh >= cum[: min(b, d)]).astype(np.int64)
        # Per-dim ILP: same family as VAQ's but ub=8, lb as above, ratio cap
        # k>10→0 (hpp:404-420 analog at hpp:413-420).
        self.bits = bitalloc.allocate_bits_per_dim(var, b, lb)
        if verbose:
            nz = self.bits[self.bits > 0]
            print(f"== binary bit alloc: {len(nz)} dims used, "
                  f"max {nz.max() if len(nz) else 0} bits")

        xp = self._project(x_train)
        self.boundaries = _quantile_boundaries(xp, self.bits)
        self.total_bits = int(self.bits.sum())
        return self

    def _project(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) @ self.eigvecs

    def _bucketize(self, xp: np.ndarray) -> np.ndarray:
        """bucket = first boundary ≥ value (encodeToBinary, hpp:564-588)."""
        d = xp.shape[1]
        buckets = np.zeros(xp.shape, dtype=np.int64)
        for j in range(d):
            bj = int(self.bits[j])
            if bj == 0:
                continue
            nb = (1 << bj) - 1
            buckets[:, j] = np.searchsorted(self.boundaries[:nb, j], xp[:, j],
                                            side="left")
        return buckets

    def _set_rows(self, packed: np.ndarray) -> None:
        """The searched state from host uint32 words: ``packed`` (the bits
        as int32), ``db01`` and ``db_pop`` on the device."""
        self.packed = _device_words(packed, self.device)
        self.n_rows = packed.shape[0]
        self.db01 = _unpack_words(self.packed, self.total_bits)
        self.db_pop = self.db01.sum(1, dtype=torch.int32)

    def encode(self, x: np.ndarray, verbose: bool = False) -> "BinaryIndex":
        self._set_rows(self.encode_queries(x))
        return self

    def encode_queries(self, queries: np.ndarray) -> np.ndarray:
        """Host (nq, W) uint32 words of ``queries`` (JAX binary.py:269)."""
        qp = self._project(queries)
        return pack_codes(self._bucketize(qp), self.bits)

    def _query_words(self, queries: np.ndarray) -> torch.Tensor:
        return _device_words(self.encode_queries(queries), self.device)

    # ------------------------------------------------------------------
    def query(self, queries: np.ndarray, k: int, backend: str = "auto",
              metric: str = "hamming") -> Tuple[np.ndarray, np.ndarray]:
        """Bit-space top-k (the reference's query(), BitVecEngine.cpp:509-519;
        Sort/Heap/EA variants collapse into one scan; JAX binary.py:274-295).

        metric: "hamming" (default) or "jaccard" (reference jaccardDist,
        DistanceFunctions.hpp:218 — the packed words, kernel H1). backend
        ("auto", "packed", "matmul"): "auto" takes "matmul" while ``db01``
        exists. Returns host (dists (nq, k), ids (nq, k) int32): int32
        Hamming or f32 Jaccard distances, ascending, ties to the lower id."""
        qw = self._query_words(queries)
        if metric == "jaccard":
            d, i = distances.jaccard_topk(self.packed, qw, k)
        else:
            if backend == "auto":
                backend = "matmul" if self.db01 is not None else "packed"
            if backend == "matmul":
                d, i = hamming_topk_matmul(
                    self.db01, self.db_pop, _unpack_words(qw, self.total_bits),
                    k)
            else:
                d, i = hamming_topk_packed(self.packed, qw, k)
        return d.cpu().numpy(), i.cpu().numpy()

    def query_rerank(self, queries: np.ndarray, x_original: np.ndarray,
                     k: int, factor: int = 10,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Binary top-(factor·k) then exact L2 rerank
        (queryRerank, BitVecEngine.cpp:521-535)."""
        kr = min(factor * k, self.n_rows)
        _, cand = self.query(queries, kr)
        x_original = np.asarray(x_original, dtype=np.float32)
        dev = self.device
        d, i = refine_topk(
            torch.as_tensor(np.asarray(queries, np.float32), device=dev),
            torch.as_tensor(x_original[np.maximum(cand, 0)], device=dev),
            torch.as_tensor(cand.astype(np.int32), device=dev), k)
        return d.cpu().numpy(), i.cpu().numpy()

    def query_naive(self, queries: np.ndarray, x_original: np.ndarray,
                    k: int, metric: str = "l2",
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan over originals (queryNaive, BitVecEngine.cpp:574-720) —
        doubles as the groundtruth generator. metric: "l2" (squared) or
        "manhattan" (reference manhattanDist, DistanceFunctions.hpp:254)."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        x = torch.as_tensor(np.asarray(x_original, np.float32),
                            device=self.device)
        if metric == "manhattan":
            d, i = distances.manhattan_topk(q, x, k)
        else:
            d, i = distances.exact_search(q, x, k)
        return d.cpu().numpy(), i.cpu().numpy()

    def _stage_dists(self, qw: torch.Tensor, n_subvectors: int):
        """(S, per-query batch size, batches of (S, b, n) int32 Hamming
        distances of each sub-vector's words) — JAX's stage stack
        (binary.py:342-355, 391-403), a batch of queries at a time."""
        w = self.packed.shape[1]
        s = max(1, min(n_subvectors, w))
        sub_w = w // s
        xw = self.packed[None]
        qb = max(1, FILTER_ELEMS // max(s * self.n_rows, 1))

        def batches():
            for q0 in range(0, qw.shape[0], qb):
                q = qw[None, q0:q0 + qb]
                yield torch.stack([hamming.popcount_dists(
                    q, xw, "xor", j * sub_w, (j + 1) * sub_w if j < s - 1 else w
                )[0] for j in range(s)])

        return s, batches

    def query_filtering(self, queries: np.ndarray, k: int, n_subvectors: int,
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Progressive sub-vector filtering, Sort variant
        (queryFiltering_Sort, BitVecEngine.cpp:1145-1208; JAX
        binary.py:325-369).

        Accumulate the Hamming distance one sub-vector at a time; after each
        round keep only the rows whose accumulated distance is still 0; stop
        at the first round where ≤ k such rows remain (or after the last
        sub-vector) and answer with the top-k by the accumulated distance
        among the rows that survived every earlier round. As in JAX, every
        round's cumulative distances are formed and each query's stopping
        round selected; here for a batch of queries at a time. Returns host
        (dists (nq, k) int32, ids (nq, k) int32), ties to the lower id."""
        s, batches = self._stage_dists(self._query_words(queries),
                                       n_subvectors)
        n = self.n_rows
        out_d, out_i = [], []
        for stages in batches():
            cum = torch.cumsum(stages, dim=0, dtype=torch.int32)  # (S, b, n)
            b = cum.shape[1]
            counts = torch.sum(cum == 0, dim=2)                   # (S, b)
            last = torch.arange(s, device=cum.device)[:, None] == s - 1
            stop = ((counts <= k) | last).to(torch.int32).argmax(0)  # first
            sel = torch.gather(cum, 0, stop[None, :, None].expand(1, b, n))[0]
            prev = torch.gather(cum, 0, (stop - 1).clamp_min(0)[None, :, None]
                                .expand(1, b, n))[0]
            alive = (stop[:, None] == 0) | (prev == 0)
            d, pos = _select_lowest(torch.where(alive, sel, FAR), k)
            out_d.append(d)
            out_i.append(pos.to(torch.int32))
        return torch.cat(out_d).cpu().numpy(), torch.cat(out_i).cpu().numpy()

    def query_filtering_heap(self, queries: np.ndarray, k: int,
                             n_subvectors: int,
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Progressive filtering, Heap variant (queryFiltering_Heap,
        BitVecEngine.cpp:1210-1259; JAX binary.py:371-413).

        The reference's lazy heap comparator ranks rows lexicographically
        by their per-subvector distance vector (d_0, d_1, …). JAX takes
        ``np.lexsort`` per query on the host; here the same order comes from
        stable sorts on the device, one a sub-vector from the last to the
        first, so ties go to the lower row as lexsort's do. Returns host
        (sub_dists (nq, k, S) int32 — the reference's
        ``IdxSubDistPair.dist`` vectors — and ids (nq, k) int32)."""
        s, batches = self._stage_dists(self._query_words(queries),
                                       n_subvectors)
        subs, ids = [], []
        for stages in batches():
            b, n = stages.shape[1:]
            order = torch.arange(n, device=stages.device).expand(b, n)
            for j in range(s - 1, -1, -1):
                key = torch.gather(stages[j], 1, order)
                order = torch.gather(
                    order, 1, torch.sort(key, dim=1, stable=True).indices)
            top = order[:, :k]
            subs.append(torch.stack([torch.gather(stages[j], 1, top)
                                     for j in range(s)], dim=2))
            ids.append(top.to(torch.int32))
        return torch.cat(subs).cpu().numpy(), torch.cat(ids).cpu().numpy()

    # ------------------------------------------------------------------
    # CRUD (reference get/append/deleteBitV, BitVecEngine.cpp:1626-1636)
    # ------------------------------------------------------------------
    def get_bitv(self, ids) -> np.ndarray:
        """Packed bitvector rows, host uint32 (numpy's indexing rules: a
        negative id counts from the end, one out of range raises)."""
        rows = np.arange(self.n_rows)[np.atleast_1d(ids)]
        sel = self.packed[torch.as_tensor(rows, device=self.device)]
        return sel.cpu().numpy().view(np.uint32)

    def append(self, x_new: np.ndarray) -> np.ndarray:
        """Encode + append rows; returns new global ids."""
        new = _device_words(self.encode_queries(x_new), self.device)
        start = self.n_rows
        new01 = _unpack_words(new, self.total_bits)
        self.packed = torch.cat([self.packed, new])
        self.db01 = torch.cat([self.db01, new01])
        self.db_pop = torch.cat([self.db_pop, new01.sum(1, dtype=torch.int32)])
        self.n_rows += new.shape[0]
        return np.arange(start, self.n_rows)

    def delete(self, ids) -> None:
        """Remove rows by id (compacting — ids above shift down, like the
        reference's vector erase); ids outside [0, n) name no row."""
        ids = np.atleast_1d(np.asarray(ids))
        keep = torch.as_tensor(np.setdiff1d(np.arange(self.n_rows), ids),
                               device=self.device)
        self.packed = self.packed[keep]
        self.db01 = self.db01[keep]
        self.db_pop = self.db_pop[keep]
        self.n_rows = keep.shape[0]

    # ------------------------------------------------------------------
    def state(self) -> Tuple[dict, dict]:
        """(numpy arrays, meta) as JAX's ``save`` writes them (uint32
        ``packed``), which ``convert.binary_index_from_numpy`` reads."""
        arrays = {
            "eigvecs": self.eigvecs,
            "bits": self.bits,
            "boundaries": self.boundaries,
        }
        if self.packed is not None:
            arrays["packed"] = self.packed.cpu().numpy().view(np.uint32)
        meta = {"bit_budget": self.bit_budget, "seed": self.seed,
                "total_bits": self.total_bits, "orig_dim": self.orig_dim,
                "n_rows": self.n_rows}
        return arrays, meta

    def save(self, path: str) -> None:
        io.save_index_npz(path, *self.state())

    @classmethod
    def load(cls, path: str, device: torch.device | str = DEFAULT
             ) -> "BinaryIndex":
        """Load an index saved by either package onto ``device``."""
        from vaq_tpu_torch.convert import binary_index_from_numpy

        return binary_index_from_numpy(*io.load_index_npz(path), device)


def _quantile_boundaries(xp: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Matlab-style quantile boundaries per dim (hpp:509-561): for b bits,
    N = 2^b − 1 boundaries at p = (i+1)/(N+1); boundary N-1..255 padded with
    +max so searchsorted never exceeds 2^b − 1."""
    n, d = xp.shape
    q = np.full((256, d), np.finfo(np.float32).max, dtype=np.float32)
    for j in range(d):
        b = int(bits[j])
        if b == 0:
            continue
        nb = (1 << b) - 1
        z = np.sort(xp[:, j])
        for i in range(nb):
            p = (i + 1) / (nb + 1)
            poi = (1 - p) * (-0.5) + p * (n - 0.5)
            left = max(int(np.floor(poi)), 0)
            right = min(int(np.ceil(poi)), n - 1)
            q[i, j] = (1 - (poi - left)) * z[left] + (poi - left) * z[right]
    return q


# ---------------------------------------------------------------------------
# Scalar-quantized LUT index (B4 binaryEncodingLUT + B11 queryLUT)
# ---------------------------------------------------------------------------

class ScalarLUTIndex:
    """Per-dimension scalar quantizer with ADC LUT search.

    The reference's ``binaryEncodingLUT`` (BitVecEngine.hpp:594-935) +
    ``queryLUT`` (hpp:1222-1343): PCA, per-dim bit allocation (same program
    as :class:`BinaryIndex`), per-dim centroids = in-bucket means between
    matlab-style quantile boundaries (``centroidsQuantile``, hpp:811-840;
    empty buckets fall back to the boundary midpoint), u8 codes per kept
    dim, and ADC search over per-dim LUTs — the port's
    :class:`vaq_tpu_torch.vaq.VAQIndex` with L = 1 subspaces, on this
    index's device (its codes tier is kernels K1/K2 at M' = kept dims).
    Training stays host numpy, as in JAX (binary.py:521-591).
    """

    def __init__(self, bit_budget: int, seed: int = DEFAULT_SEED,
                 device: torch.device | str = DEFAULT):
        self.bit_budget = bit_budget
        self.seed = seed
        self.device = resolve(device)
        self._vaq = None

    def train(self, x_train: np.ndarray, verbose: bool = False):
        from vaq_tpu_torch.config import SearchMethod, VAQConfig
        from vaq_tpu_torch.vaq import PAD_SENTINEL, VAQIndex

        x_train = np.asarray(x_train, dtype=np.float32)
        d = x_train.shape[1]

        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        evals, evecs = evals[order], evecs[:, order]
        var = evals / evals.sum()
        var = np.where(var < 1e-11, 1e-17, var)

        b = self.bit_budget
        cum = np.cumsum(var)
        thresh = 0.99 * cum[min(b, d) - 1]
        lb = np.zeros(d, dtype=np.int64)
        lb[: min(b, d)] = (thresh >= cum[: min(b, d)]).astype(np.int64)
        bits = bitalloc.allocate_bits_per_dim(var, b, lb)

        # kept dims = leading run of non-zero allocations (hpp:843-849)
        kept = 0
        while kept < d and bits[kept] > 0:
            kept += 1
        kept = max(kept, 1)

        xp = x_train @ evecs.astype(np.float32)
        cmax = 256
        centroids = np.full((kept, cmax, 1), PAD_SENTINEL, dtype=np.float32)
        for j in range(kept):
            nb = 1 << int(bits[j])
            z = np.sort(xp[:, j])
            # quantile boundaries incl. extremes (hpp:812-824)
            qs = np.empty(nb + 1, dtype=np.float64)
            qs[0], qs[-1] = z[0], z[-1]
            n = len(z)
            for i in range(nb - 1):
                p = (i + 1) / nb
                poi = (1 - p) * (-0.5) + p * (n - 0.5)
                left = max(int(np.floor(poi)), 0)
                right = min(int(np.ceil(poi)), n - 1)
                qs[i + 1] = (1 - (poi - left)) * z[left] + (poi - left) * z[right]
            # in-bucket means; empty bucket → boundary midpoint
            hi = np.searchsorted(z, qs[1:], side="right")
            lo = np.concatenate([[0], hi[:-1]])
            for i in range(nb):
                if hi[i] > lo[i]:
                    centroids[j, i, 0] = z[lo[i]:hi[i]].mean()
                else:
                    centroids[j, i, 0] = (qs[i] + qs[i + 1]) / 2.0

        cfg = VAQConfig(bit_budget=int(bits[:kept].sum()), subspace_num=d,
                        min_bits=0, max_bits=8,
                        methods=SearchMethod.SORT, seed=self.seed)
        vaq = VAQIndex(cfg, device=self.device)
        vaq.eigvecs = evecs.astype(np.float32)
        vaq.eigvals = evals.astype(np.float32)
        vaq.var_per_subs = var.astype(np.float32)
        vaq.cum_var_per_subs = cum
        vaq.subs_len = 1
        vaq.highest_subs = kept
        vaq.orig_dim = d
        vaq.bits = bits[:kept]
        vaq.centroid_counts = (1 << bits[:kept]).astype(np.int64)
        vaq.centroids = centroids
        self._vaq = vaq
        if verbose:
            print(f"== scalar LUT: {kept}/{d} dims kept, "
                  f"bits sum={bits[:kept].sum()}")
        return self

    def encode(self, x: np.ndarray, verbose: bool = False):
        self._vaq.encode(x, verbose=verbose)
        return self

    def query(self, queries: np.ndarray, k: int, **kw):
        return self._vaq.search(queries, k, **kw)

    def query_refine(self, queries: np.ndarray, x_original: np.ndarray,
                     k: int, factor: int = 10):
        """queryLUT's built-in exact refine (refineAnswer, hpp:1345-1387)."""
        _, cand = self._vaq.search(queries, min(factor * k, self._vaq.n_rows))
        return self._vaq.refine(queries, cand, x_original, k)

    def save(self, path: str) -> None:
        self._vaq.save(path)

    @classmethod
    def load(cls, path: str, device: torch.device | str = DEFAULT
             ) -> "ScalarLUTIndex":
        from vaq_tpu_torch.vaq import VAQIndex
        obj = cls(bit_budget=0, device=device)
        obj._vaq = VAQIndex.load(path, device=obj.device)
        obj.bit_budget = obj._vaq.config.bit_budget
        return obj


# ---------------------------------------------------------------------------
# Disk-resident streaming scan (B9)
# ---------------------------------------------------------------------------

def query_naive_streaming(path: str, dim: int, queries: np.ndarray, k: int,
                          batch_rows: int = 262144, dtype=np.float32,
                          device: torch.device | str = DEFAULT
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact L2 top-k over a dataset streamed from disk in row chunks (JAX
    binary.py:622-659).

    The reference's disk-resident scan (queryNaiveParallelDiskResident,
    BitVecEngine.cpp:1441-1624): read ``batch_rows`` rows (a memmap slice),
    take the chunk's top-k on ``device`` (:func:`distances.exact_search`),
    offset its ids by the chunk's base (cpp:1488), merge into the global
    answers on the host (cpp:1599-1611; the native merge, else a stable
    sort). Device memory stays O(chunk)."""
    dev = resolve(device)
    queries = np.asarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    q_dev = torch.as_tensor(queries, device=dev)
    mm = np.memmap(path, dtype=dtype, mode="r")
    n = mm.shape[0] // dim
    best_d = np.full((nq, k), np.inf, dtype=np.float32)
    best_i = np.full((nq, k), -1, dtype=np.int32)
    for start in range(0, n, batch_rows):
        rows = np.asarray(mm[start * dim:(start + min(batch_rows, n - start))
                             * dim], dtype=np.float32).reshape(-1, dim)
        kk = min(k, rows.shape[0])
        d, i = distances.exact_search(q_dev, torch.tensor(rows, device=dev),
                                      kk)
        d, i = d.cpu().numpy(), (i.cpu().numpy() + start).astype(np.int32)
        if not native.merge_topk(best_d, best_i, d, i):
            cd = np.concatenate([best_d, d], axis=1)
            ci = np.concatenate([best_i, i], axis=1)
            order = np.argsort(cd, axis=1, kind="stable")[:, :k]
            best_d = np.take_along_axis(cd, order, axis=1)
            best_i = np.take_along_axis(ci, order, axis=1)
    return best_d, best_i


# ---------------------------------------------------------------------------
# Cluster-pruned Hamming queries (B6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HammingClusterState:
    """Bucketed packed bitvectors grouped by (L2) cluster of the originals."""

    centroids: np.ndarray        # (ncl, d) f32 cluster centroids
    cap: int
    bucket_words: torch.Tensor   # (ncl, cap, W) int32 (uint32 bits)
    bucket_ids: torch.Tensor     # (ncl, cap) int32, -1 padding
    sizes: torch.Tensor          # (ncl,) int32 member counts


def build_hamming_clusters(index: BinaryIndex, x_original: np.ndarray,
                           n_clusters: int, iters: int = 25,
                           seed: int = DEFAULT_SEED,
                           device: torch.device | str = DEFAULT
                           ) -> HammingClusterState:
    """k-means over the original vectors (the port's ``kmeans.fit``);
    bitvectors grouped into buckets padded to the largest cluster (the
    loadCentroids/loadClusterInfo + queryWithClusterInfo build,
    BitVecEngine.cpp:204-449; JAX binary.py:677-704). Members sit in row
    order within their bucket, as JAX's stable host grouping places them.
    Both run on ``device``, where the state lives; search it with an index
    on the same device."""
    dev = resolve(device)
    x = torch.as_tensor(np.asarray(x_original, dtype=np.float32), device=dev)
    cents, assign = kmeans.fit(x, n_clusters, iters=iters, seed=seed)
    sizes = torch.bincount(assign, minlength=n_clusters)
    cap = int(sizes.max())
    order = torch.sort(assign, stable=True).indices
    starts = torch.cumsum(sizes, 0) - sizes
    members = assign[order]
    slot = torch.arange(order.shape[0], device=dev) - starts[members]
    w = index.packed.shape[1]
    words = torch.zeros((n_clusters, cap, w), dtype=torch.int32, device=dev)
    ids = torch.full((n_clusters, cap), -1, dtype=torch.int32, device=dev)
    words[members, slot] = index.packed.to(dev)[order]
    ids[members, slot] = order.to(torch.int32)
    return HammingClusterState(centroids=cents.cpu().numpy(), cap=cap,
                               bucket_words=words, bucket_ids=ids,
                               sizes=sizes.to(torch.int32))


def _hamming_probe_scan(qp_f32, qwords, bucket_words, bucket_ids, centroids,
                        sizes, k, p_visit, p_max, qcap, cb=8):
    """One batch mirroring ivf.probe_scan for Hamming buckets (JAX
    binary.py:707-753): probe by L2 over originals → MoE dispatch → blocked
    XOR+popcount scoring (H1, ``cb`` clusters a launch) → per-cluster top-k
    → per-query merge. Returns (dists (nq, k) int32, 2^30 where no
    candidate; ids (nq, k) int32)."""
    nq = qp_f32.shape[0]
    ncl, cap, w = bucket_words.shape
    dev = qwords.device

    cd = probe_ops.cluster_sq_dists(qp_f32, torch.tensor(centroids,
                                                         device=dev))
    probe, active = probe_ops.dynamic_probe(cd, sizes, k, p_visit, p_max)
    table, ok, ent_c, ent_r = probe_ops.dispatch_table(probe, active, ncl,
                                                       qcap)
    qw_pad = torch.cat([qwords, torch.zeros((1, w), dtype=qwords.dtype,
                                            device=dev)])
    qsl = qw_pad[table.to(torch.int64)]                     # (ncl, qcap, W)
    nb = -(-ncl // cb)
    kk = min(k, cap)

    def score_fn(b):
        c0, c1 = b * cb, min(ncl, (b + 1) * cb)
        dist = hamming.popcount_dists(qsl[c0:c1], bucket_words[c0:c1])
        # negative distance = descending-is-better score; padding → -inf
        return torch.where(bucket_ids[c0:c1, None, :] >= 0,
                           -dist.to(torch.float32), -torch.inf)

    vals, pos = probe_ops.blocked_cluster_topk(score_fn, nb, kk)
    # resolve ids cluster-major with a per-row gather
    ids_k = torch.gather(bucket_ids, 1, pos.reshape(ncl, qcap * kk)
                         ).reshape(ncl, qcap, kk)
    top_s, top_i = probe_ops.gather_merge_topk(vals, ids_k, ok, ent_c, ent_r,
                                               nq, k)
    dist = torch.where(torch.isfinite(top_s), -top_s, float(FAR))
    return dist.to(torch.int32), top_i


def query_hamming_clusters(index: BinaryIndex, state: HammingClusterState,
                           queries: np.ndarray, k: int,
                           n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
    """Visit each query's nearest clusters — at least ``n_probe``, and at
    least until ≥ k members have been seen (the reference's dynamic rule,
    queryWithClusterInfo BitVecEngine.cpp:204-449/537-551) — and
    Hamming-scan only their buckets, in one batched dispatch (JAX
    binary.py:756-779, its qcap and block rules). Ties go to the lower
    candidate position (probe slot, then rank in the cluster), as JAX's
    ``top_k`` gives them."""
    queries = np.asarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    qwords = index._query_words(queries)
    ncl = state.centroids.shape[0]
    p_visit = max(1, min(int(n_probe), ncl))
    cum = np.cumsum(np.sort(state.sizes.cpu().numpy()))
    p_floor = int(np.searchsorted(cum, k) + 1)
    p_max = min(ncl, max(p_visit, p_floor))
    qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl)
    cb = min(ncl, max(1, PROBE_BLOCK_ELEMS // max(qcap * state.cap, 1)))
    d, i = _hamming_probe_scan(
        torch.as_tensor(queries, device=index.device), qwords,
        state.bucket_words, state.bucket_ids, state.centroids, state.sizes,
        k, p_visit, p_max, qcap, cb=cb)
    return d.cpu().numpy(), i.cpu().numpy()
