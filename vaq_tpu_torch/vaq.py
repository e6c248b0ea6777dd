"""The VAQ index: train → encode → search → refine, in PyTorch.

The counterpart of ``vaq_tpu/vaq.py`` (reference ``VAQ`` class,
``bitvecengine/VAQ.{hpp,cpp}``). The trained index is a handful of numpy
arrays (rotation, padded codebooks) plus the codes, which live on the
index's ``device`` as a row-major (n, M') tensor: u8 when every subspace has
≤ 8 bits, int32 otherwise.

Stage mapping (reference file:line → JAX counterpart):
  train    VAQ::train   VAQ.cpp:11-661   vaq.py:206-317
  encode   VAQ::encode  VAQ.cpp:663-748  vaq.py:329-378
  search   VAQ::search  VAQ.cpp:776-847  vaq.py:419-489, 587-819
  refine   VAQ::refine  VAQ.cpp:849-876  vaq.py:1063-1075

``search`` serves two tiers: ``"decoded"`` (bf16 decoded rows, a plain GEMM;
what ``"auto"`` picks) and ``"codes"`` (only the u8 codes resident, searched
by the hand-written CUDA kernels of ``ops/scan_codes.py``). The other JAX
backends come with later port slices and raise ``ConfigError`` until then.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vaq_tpu_torch import bitalloc, io, kmeans, pca
from vaq_tpu_torch.config import SearchMethod, VAQConfig
from vaq_tpu_torch.errors import ConfigError, NotReadyError, ShapeError
from vaq_tpu_torch.ops import scan_codes, scan_decoded, scan_lut

# Sentinel for padded codebook rows: large enough to never win an argmin,
# small enough that its square stays finite in f32.
PAD_SENTINEL = 1e18

# JAX backends that later port slices bring (ROADMAP.md, queue 1).
_LATER_BACKENDS = {
    "decoded8": "the int8 tier (ROADMAP slice 2)",
    "ivf": "the TI/IVF cluster probe (ROADMAP slice 2)",
    "lut": "the FAST/LUT family (ROADMAP slice 3)",
    "fast4": "the FAST/LUT family (ROADMAP slice 3)",
    "lut_gather": "the FAST/LUT family (ROADMAP slice 3)",
}


# Rows per block of _encode_blocked: bounds its (M, rows, C) f32 scores
# (1 GB at M = 32, C = 256).
ENCODE_BLOCK_ROWS = 32768
# Host rows moved to the device per encode step.
ENCODE_CHUNK_ROWS = 2_000_000


def _check_backend(backend: str, served: Tuple[str, ...]) -> None:
    if backend in _LATER_BACKENDS:
        raise ConfigError(f"backend {backend!r} is not ported yet: it comes "
                          f"with {_LATER_BACKENDS[backend]}")
    if backend not in served:
        raise ConfigError(f"unknown backend {backend!r}")


def _encode_blocked(xp: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes for all rows, per subspace.

    xp (n, M·L) projected rows; centroids (M, C, L) padded, f32, same device.
    Returns (n, M) int64 codes; argmin ties go to the lower centroid, as in
    JAX. The argmin stays in f32: padded rows hold PAD_SENTINEL, whose
    ‖c‖² ≈ 1e36 must stay finite (it would overflow an f16 score).
    """
    n = xp.shape[0]
    m, _, l = centroids.shape
    c2 = torch.sum(centroids * centroids, dim=2)          # (M, C)
    cent_t = centroids.transpose(1, 2)                     # (M, L, C)
    codes = torch.empty((n, m), dtype=torch.int64, device=xp.device)
    for start in range(0, n, ENCODE_BLOCK_ROWS):
        blk = xp[start:start + ENCODE_BLOCK_ROWS].reshape(-1, m, l)
        blk = blk.transpose(0, 1)                          # (M, nb, L)
        # ‖x‖² − 2x·c + ‖c‖²; ‖x‖² is constant in the argmin, dropped
        xc = torch.bmm(blk, cent_t)                        # (M, nb, C)
        codes[start:start + blk.shape[1]] = torch.argmin(
            c2[:, None, :] - 2.0 * xc, dim=2).T
    return codes


@dataclasses.dataclass
class VAQIndex:
    """A trained (or in-training) VAQ index on one torch device."""

    config: VAQConfig
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))

    # Rotation / truncation state (train).
    eigvecs: Optional[np.ndarray] = None        # (d, d) f32
    eigvals: Optional[np.ndarray] = None        # (d,) f32
    var_per_subs: Optional[np.ndarray] = None   # (M,) f32
    cum_var_per_subs: Optional[np.ndarray] = None
    subs_len: int = 0                           # L
    highest_subs: int = 0                       # M' = kept subspaces
    orig_dim: int = 0                           # pre-padding feature dim

    # Quantizer state.
    bits: Optional[np.ndarray] = None           # (M',) int
    centroids: Optional[np.ndarray] = None      # (M', Cmax, L) f32, padded
    centroid_counts: Optional[np.ndarray] = None  # (M',) = 2^bits_i

    # Encoded database, row-major (n, M') on `device`.
    codes: Optional[torch.Tensor] = None
    n_rows: int = 0

    # Decoded tier (bf16 reconstruction + exact f32 norms), rebuilt lazily.
    decoded: Optional[torch.Tensor] = None      # (n, M'·L) bf16
    decoded_norms: Optional[torch.Tensor] = None  # (n,) f32

    # LUT u8 quantization: no ported path reads it yet; kept so that an index
    # saved by the JAX package survives a load/save round trip intact.
    lut_offsets: Optional[np.ndarray] = None
    lut_scales: Optional[np.ndarray] = None

    # Tombstoned row ids (set by the JAX package's delete(), read from npz).
    deleted_ids: Optional[np.ndarray] = None

    # Device-side caches (not persisted).
    _ev_dev: Optional[torch.Tensor] = None
    _deleted_dev: Optional[torch.Tensor] = None
    _dec_table: Optional[torch.Tensor] = None
    _dec_rows: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.device = torch.device(self.device)

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def total_dim(self) -> int:
        """Dims actually used for ADC = M' · L (VAQ.cpp:336)."""
        return self.highest_subs * self.subs_len

    @property
    def max_centroids(self) -> int:
        return 1 << self.config.max_bits

    # ------------------------------------------------------------------
    # Train
    # ------------------------------------------------------------------
    def train(self, x_train: np.ndarray, verbose: bool = False) -> "VAQIndex":
        """PCA rotation + variance balancing + bit allocation + codebooks."""
        cfg = self.config
        dev = self.device
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = x_train.shape[1]
        x_train = io.pad_dims(x_train, cfg.subspace_num)

        t0 = time.perf_counter()
        rot = pca.train_rotation(x_train, cfg.subspace_num,
                                 cfg.percent_var_explained, cfg.seed,
                                 device=dev)
        self.eigvecs = rot.eigvecs
        self.eigvals = rot.eigvals
        self.var_per_subs = rot.var_per_subs
        self.cum_var_per_subs = rot.cum_var_per_subs
        self.subs_len = rot.subs_len
        self.highest_subs = rot.highest_subs
        self._ev_dev = None
        self._dec_table = self._dec_rows = None
        if verbose:
            print(f"== PCA+rotation: {time.perf_counter() - t0:.3f}s "
                  f"(kept {self.highest_subs}/{cfg.subspace_num} subspaces)")

        # Bit allocation — the exact ILP over the kept subspaces.
        t0 = time.perf_counter()
        if cfg.hardcoded_bits is not None:
            bits = np.zeros(self.highest_subs, dtype=np.int64)
            hc = np.asarray(cfg.hardcoded_bits[: self.highest_subs])
            bits[: hc.shape[0]] = hc
            bits = bitalloc.fixup_under_budget(bits, cfg.bit_budget, cfg.max_bits)
        else:
            bits = bitalloc.allocate_bits(
                self.var_per_subs[: self.highest_subs],
                cfg.bit_budget,
                cfg.min_bits,
                cfg.max_bits,
                cum_var=self.cum_var_per_subs[: self.highest_subs],
                percent_var_explained=cfg.percent_var_explained,
            )
        self.bits = bits
        self.centroid_counts = (1 << bits).astype(np.int64)
        if verbose:
            print(f"== bit allocation: {list(bits)} "
                  f"(sum={bits.sum()}, {time.perf_counter() - t0:.3f}s)")

        # Per-subspace codebooks. Only sampled rows reach the device
        # (≤ 256·2^bits per subspace). Subspaces with identical (centroid
        # count, sample size) train as one batched k-means.
        t0 = time.perf_counter()
        m, l = self.highest_subs, self.subs_len
        centroids = np.full((m, self.max_centroids, l), PAD_SENTINEL,
                            dtype=np.float32)
        n_train = x_train.shape[0]
        ev_dev = self._eigvecs_device()

        def samp_of(s):
            k = int(self.centroid_counts[s])
            samp = max(k * 256,
                       256 * (1 << (cfg.bit_budget // cfg.subspace_num)))
            return min(samp, n_train)

        def project_sample(s, samp):
            """Project only subspace s's sampled raw rows (host gather →
            device matmul against the L relevant rotation columns)."""
            perm = np.random.default_rng(cfg.seed + s).permutation(
                n_train)[:samp]
            rows = torch.as_tensor(x_train[perm], device=dev)
            return rows @ ev_dev[:, s * l:(s + 1) * l]

        groups: dict = {}
        special = []
        for s in range(m):
            if (cfg.hierarchical_kmeans or cfg.binary_kmeans) and bits[s] > 8:
                raise ConfigError(
                    "hierarchical/binary k-means for >8-bit subspaces is not "
                    "ported yet (ROADMAP queue 1, item 6 remainder)")
            groups.setdefault((int(self.centroid_counts[s]), samp_of(s)),
                              []).append(s)

        for (k, samp), subs in groups.items():
            # device budget: (G, samp, k) distances for the whole group
            if len(subs) * samp * k > (1 << 29):
                special.extend(subs)
                continue
            xs = torch.stack([project_sample(s, samp) for s in subs])
            cents = kmeans.fit_many(xs, k, iters=cfg.kmeans_iters,
                                    seed=cfg.seed).cpu().numpy()
            for gi, s in enumerate(subs):
                centroids[s, :k] = cents[gi]

        for s in special:
            k = int(self.centroid_counts[s])
            c, _ = kmeans.fit(project_sample(s, samp_of(s)), k,
                              iters=cfg.kmeans_iters, seed=cfg.seed + s)
            centroids[s, :k] = c.cpu().numpy()
        self.centroids = centroids
        if verbose:
            print(f"== codebooks: {time.perf_counter() - t0:.3f}s")
        return self

    def build(self, x: np.ndarray) -> "VAQIndex":
        """train + encode."""
        return self.train(x).encode(x)

    # ------------------------------------------------------------------
    # Encode — host row chunks go to the device one at a time, so device
    # memory stays O(chunk) + O(codes).
    # ------------------------------------------------------------------
    def encode(self, x: np.ndarray) -> "VAQIndex":
        if self.centroids is None:
            raise NotReadyError("encode() requires train() first")
        x = io.pad_dims(np.asarray(x, dtype=np.float32),
                        self.config.subspace_num)
        n = x.shape[0]
        cent_dev = torch.as_tensor(self.centroids, device=self.device)
        ev_dev = self._eigvecs_device()
        dtype = torch.uint8 if int(self.bits.max()) <= 8 else torch.int32
        codes = torch.empty((n, self.highest_subs), dtype=dtype,
                            device=self.device)
        for start in range(0, n, ENCODE_CHUNK_ROWS):
            rows = torch.as_tensor(x[start:start + ENCODE_CHUNK_ROWS],
                                   device=self.device)
            codes[start:start + rows.shape[0]] = _encode_blocked(
                rows @ ev_dev, cent_dev).to(dtype)
        self.codes = codes
        self.n_rows = n
        self.decoded = None
        self.decoded_norms = None
        return self

    def codes_rowmajor(self) -> np.ndarray:
        """Host copy of the (n, M') codes."""
        return self.codes.cpu().numpy()

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------
    def _eigvecs_device(self) -> torch.Tensor:
        if self._ev_dev is None:
            self._ev_dev = torch.as_tensor(
                np.ascontiguousarray(self.eigvecs[:, : self.total_dim]),
                device=self.device)
        return self._ev_dev

    def _deleted_device(self) -> torch.Tensor:
        """Device copy of the tombstoned ids (for the on-device filter)."""
        if self._deleted_dev is None or \
                self._deleted_dev.shape[0] != len(self.deleted_ids):
            self._deleted_dev = torch.as_tensor(
                self.deleted_ids.astype(np.int32), device=self.device)
        return self._deleted_dev

    def _tombstone_norms(self, norms: torch.Tensor) -> torch.Tensor:
        """Deleted rows get +inf norms, so the decoded scan excludes them
        exactly."""
        if self.deleted_ids is not None and len(self.deleted_ids):
            norms[self._deleted_device().to(torch.int64)] = torch.inf
        return norms

    def _ensure_decoded(self) -> None:
        """Materialize the decoded bf16 database for the decoded tier."""
        if self.decoded is None:
            dec, norms = scan_decoded.decode_db(
                self.codes, torch.as_tensor(self.centroids,
                                            device=self.device))
            self.decoded = dec
            self.decoded_norms = self._tombstone_norms(norms)

    def _require_codes_bits(self) -> None:
        """The codes tier reads u8 codes, so it serves only ≤ 8-bit
        subspaces; asking for it on a wider index fails loudly instead of
        truncating codes."""
        if int(self.bits.max()) > 8:
            raise ConfigError(
                "backend='codes' supports <= 8-bit subspaces (codes must fit "
                f"u8). This index allocates up to {int(self.bits.max())} bits "
                "— use backend='decoded' or cap the config at max8.")

    def _codes_block_rows(self, k: int) -> Optional[int]:
        """Window size for the codes tier, unchanged from the JAX version
        (vaq.py:506-528): the window size decides which candidates survive,
        so changing it changes results.

        The window scan keeps one candidate per (query, window), so recall
        needs windows ≫ k: aim for ≥ 64 windows per requested neighbour,
        floor at 16 rows, cap at 512. Returns None when even 16-row windows
        cannot give 64·k windows — the caller serves the decoded tier then
        (the same ADC quantity, and the decoded db is tiny at such n) —
        unless the decoded db would exceed ~1 GB."""
        br = self.n_rows // (64 * k)
        if br < 16:
            if self.n_rows * self.total_dim * 2 > (1 << 30):
                return 16
            return None
        return 1 << (min(br, 512).bit_length() - 1)

    def _codes_tier(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Lazily built (bf16 decode table, f32 decode rows) for the codes
        tier; they depend only on the centroids."""
        if self._dec_table is None:
            self._dec_table = scan_codes.build_decode_table(
                self.centroids, self.device)
            self._dec_rows = scan_codes.build_decode_rows(
                self.centroids, self.device)
        return self._dec_table, self._dec_rows

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def search_device(self, queries_dev: torch.Tensor, k: int,
                      backend: str = "decoded"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One query batch on the device; results stay there.

        queries_dev (nq, padded d) f32 on the index's device. ``backend``:
        "decoded" or "codes". Returns (sq_dists (nq, k) f32 ascending,
        labels (nq, k) int32)."""
        if backend == "codes":
            self._require_codes_bits()
            br = self._codes_block_rows(k)
            if br is None:
                backend = "decoded"
            else:
                # Tombstones: the codes tier has no norms to poison, so it
                # over-fetches k + #deleted and filters by id on the device.
                dec_table, dec_rows = self._codes_tier()
                qp = pca.project(queries_dev, self._eigvecs_device())
                n_del = (0 if self.deleted_ids is None
                         else len(self.deleted_ids))
                k_fetch = min(k + n_del, self.n_rows)
                d, i = scan_codes.decode_scan_topk(
                    self.codes, dec_table, dec_rows, qp, k_fetch,
                    block_rows=br)
                if n_del == 0:
                    return (d, i) if k_fetch == k else (d[:, :k], i[:, :k])
                dead = torch.isin(i, self._deleted_device())
                d = torch.where(dead, torch.inf, d)
                i = torch.where(dead, -1, i)
                top, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
                i = torch.gather(i, 1, pos)
                return top, torch.where(torch.isfinite(top), i, -1)
        _check_backend(backend, ("decoded",))
        self._ensure_decoded()
        return scan_decoded.decoded_search_e2e(
            queries_dev, self._eigvecs_device(), self.decoded,
            self.decoded_norms, k)

    def search(self, queries: np.ndarray, k: int, query_batch: int = 512,
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """ADC top-k search for a query batch; host arrays in and out.

        Returns (sq_dists (nq, k) f32, labels (nq, k) int32), ascending.
        backend: "decoded" (bf16 reconstruction GEMM), "codes" (only the u8
        codes resident, searched by the CUDA kernels K1/K2) or "auto", which
        picks "decoded" as the JAX version does for non-FAST configs.
        """
        cfg = self.config
        if self.eigvecs is None:
            raise NotReadyError("search() requires train() first")
        if self.codes is None:
            raise NotReadyError("search() requires encode() first")
        _check_backend(backend, ("auto", "decoded", "codes"))
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ShapeError(f"queries must be (nq, d), got {queries.shape}")
        if queries.shape[1] > self.eigvecs.shape[0] or \
                (self.orig_dim and queries.shape[1] != self.orig_dim):
            raise ShapeError(
                f"query dim {queries.shape[1]} does not match index dim "
                f"{self.orig_dim}")
        queries = io.pad_dims(queries, cfg.subspace_num)
        if backend == "auto":
            fast = cfg.methods & (SearchMethod.FAST | SearchMethod.FAST2
                                  | SearchMethod.FAST3)
            if fast and self.lut_offsets is not None:
                raise ConfigError(
                    "quantized-LUT (FAST) search is not ported yet: it comes "
                    f"with {_LATER_BACKENDS['lut']}")
            backend = "decoded"
        nq = queries.shape[0]
        all_d = np.empty((nq, k), dtype=np.float32)
        all_i = np.empty((nq, k), dtype=np.int32)
        for start in range(0, nq, query_batch):
            qb = torch.as_tensor(queries[start:start + query_batch],
                                 device=self.device)
            d, i = self.search_device(qb, k, backend=backend)
            all_d[start:start + qb.shape[0]] = d.cpu().numpy()
            all_i[start:start + qb.shape[0]] = i.cpu().numpy()
        return all_d, all_i

    # ------------------------------------------------------------------
    # Refine
    # ------------------------------------------------------------------
    def refine(self, queries: np.ndarray, labels: np.ndarray,
               x_original: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact rerank of the R candidates per query against the original
        vectors (reference VAQ::refine, VAQ.cpp:849-876)."""
        queries = np.asarray(queries, dtype=np.float32)
        x_original = np.asarray(x_original, dtype=np.float32)
        labels = np.asarray(labels)
        cands = torch.as_tensor(x_original[np.maximum(labels, 0)],
                                device=self.device)           # (nq, R, d)
        d, i = scan_lut.refine_topk(
            torch.as_tensor(queries[:, : x_original.shape[1]],
                            device=self.device),
            cands,
            torch.as_tensor(labels.astype(np.int32), device=self.device), k)
        return d.cpu().numpy(), i.cpu().numpy()

    # ------------------------------------------------------------------
    # Persistence — the JAX package's .npz layout (vaq.py:1080-1111)
    # ------------------------------------------------------------------
    def state(self) -> Tuple[dict, dict]:
        """The index's state as (numpy arrays, meta): what save() writes and
        convert.index_from_numpy reads."""
        arrays = {
            "eigvecs": self.eigvecs,
            "eigvals": self.eigvals,
            "var_per_subs": self.var_per_subs,
            "cum_var_per_subs": self.cum_var_per_subs,
            "bits": self.bits,
            "centroids": self.centroids,
            "centroid_counts": self.centroid_counts,
        }
        if self.codes is not None:
            codes = self.codes_rowmajor()
            if codes.dtype != np.uint8:   # the JAX package stores u16 there
                codes = codes.astype(np.uint16 if int(self.bits.max()) <= 16
                                     else np.int32)
            arrays["codes"] = codes
        if self.lut_offsets is not None:
            arrays["lut_offsets"] = self.lut_offsets
            arrays["lut_scales"] = self.lut_scales
        if self.deleted_ids is not None and len(self.deleted_ids):
            arrays["deleted_ids"] = self.deleted_ids
        meta = {
            "config": {
                **{k: v for k, v in dataclasses.asdict(self.config).items()
                   if k != "methods" and k != "hardcoded_bits"},
                "methods": int(self.config.methods),
                "hardcoded_bits": list(self.config.hardcoded_bits)
                if self.config.hardcoded_bits else None,
            },
            "subs_len": self.subs_len,
            "highest_subs": self.highest_subs,
            "orig_dim": self.orig_dim,
            "n_rows": self.n_rows,
        }
        return arrays, meta

    def save(self, path: str) -> None:
        io.save_index_npz(path, *self.state())

    @classmethod
    def load(cls, path: str, device: torch.device | str = "cpu"
             ) -> "VAQIndex":
        """Load an index saved by either package onto ``device``."""
        from vaq_tpu_torch.convert import index_from_numpy

        arrays, meta = io.load_index_npz(path)
        return index_from_numpy(arrays, meta, device)
