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
  CRUD     get/append/deleteBitV, BitVecEngine.cpp:1626-1636  vaq.py:824-942
  refine   VAQ::refine  VAQ.cpp:849-876  vaq.py:1063-1075
  interop  saveCentroids/saveCodebook, IO.hpp:736-772  vaq.py:1113-1160
  shard    disk-resident chunk merge, BitVecEngine.cpp:1441-1624
                                                   vaq.py:947-1058

``train`` covers every config, the >8-bit hierarchical and binary-split
codebooks included (``kmeans.hierarchical_fit``/``binary_split_fit``).
``add`` appends encoded rows; ``delete`` tombstones rows, which every tier
then excludes (+inf norms on the decoded tiers, poisoned probe buckets,
over-fetch and filter on the codes and LUT paths). ``shard`` splits the
decoded, int8, codes and probe tiers over a ``parallel.Mesh``, whose shards
``search_device``/``search`` then scan and merge.

``search`` serves the JAX package's backends: ``"decoded"`` (bf16 decoded
rows, a plain GEMM), ``"decoded8"`` (the int8 tier, one scale per
dimension), ``"codes"`` (only the u8 codes resident, searched by the
hand-written CUDA kernels K1/K2 of ``ops/scan_codes.py``), ``"ivf"`` (the
TI/IVF cluster probe of ``ivf.py``, kernels K5/K7, once ``attach_ivf`` has
built its buckets) and the FAST/LUT family: ``"fast4"`` (the window scan
over per-query LUTs, kernels K3/K4), ``"lut_gather"`` (the LUT gather scan
of ``ops/scan_lut.py``) and ``"lut"``, which picks among the codes tier,
``fast4`` and the gather scan. ``"auto"`` takes the probe when the config
has TI and the probe state exists, ``"lut"`` on a FAST-family config whose
LUT quantization was learned (``learn_quantization``), else ``"decoded"``.
:func:`_lut_route` holds the whole rule. The index runs on ``device``,
``"cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from vaq_tpu_torch import bitalloc, io, kmeans, pca, rng
from vaq_tpu_torch.config import SearchMethod, VAQConfig
from vaq_tpu_torch.device import DEFAULT, resolve
from vaq_tpu_torch.errors import ConfigError, NotReadyError, ShapeError
from vaq_tpu_torch.ivf import poison_deleted
from vaq_tpu_torch.ops import scan_codes, scan_decoded, scan_lut

# Sentinel for padded codebook rows: large enough to never win an argmin,
# small enough that its square stays finite in f32.
PAD_SENTINEL = 1e18

# Backends of search(); search_device serves the first three.
BACKENDS = ("decoded", "decoded8", "codes", "ivf", "auto", "lut", "fast4",
            "lut_gather")
# Routes of _lut_route that run on per-query LUTs (or, for "lut_codes", that
# "lut" sends to the codes tier): over-fetch and compact tombstones on the
# host, as JAX's search() does for them.
LUT_ROUTES = ("lut_codes", "fast4", "lut_gather")
_FAST_FAMILY = SearchMethod.FAST | SearchMethod.FAST2 | SearchMethod.FAST3

# The α grid of the LUT quantization search (reference VAQ.cpp:1118-1187,
# vaq_tpu/vaq.py:572-573), its sample cap and its loss block.
LUT_ALPHAS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1)
LUT_SAMPLE_CAP = 65536
_LUT_LOSS_BLOCK = 1024


# Rows per block of _encode_blocked, and the elements its (M, rows, C) f32
# scores may hold: 1 GB, 32,768 rows at M = 32, C = 256, 1,024 rows at
# C = 8,192 (13-bit subspaces).
ENCODE_BLOCK_ROWS = 32768
ENCODE_BLOCK_ELEMS = 1 << 28
# Host rows moved to the device per encode step.
ENCODE_CHUNK_ROWS = 2_000_000
# Subspaces above this many bits train by the hierarchical or binary-split
# k-means when the config asks for it (the reference's --kmeans-ver 1|2).
STANDARD_BITS = 8


def _lut_route(backend: str, methods: SearchMethod, max_bits: int,
               n_rows: int, k: int, codes_br: Optional[int],
               quantized: bool, on_cuda: bool, has_ivf: bool) -> str:
    """Which path ``search`` takes: JAX's rule (vaq_tpu/vaq.py:626-800) with
    ``jax.default_backend() != "cpu"`` read as ``on_cuda``.

    ``k`` is what a LUT path fetches (k + #deleted, at most n, when rows are
    tombstoned) and ``codes_br`` is ``_codes_block_rows(k)``; ``quantized``
    means a FAST-family config with learned LUT quantizers; ``has_ivf``
    that ``attach_ivf`` has built probe state. Returns
    "decoded", "decoded8", "codes", "ivf", "lut_codes" (the codes tier, K1/K2,
    serving a "lut" request), "fast4" (``fast4_scan_topk``, K3/K4) or
    "lut_gather" (``adc_scan_topk``). Raises ConfigError for an unknown
    backend, and for "fast4" on subspaces of more than 4 bits (the
    reference's constraint, VAQ.cpp:1263-1266).
    """
    if backend not in BACKENDS:
        raise ConfigError(f"unknown backend {backend!r}")
    if backend == "auto":
        if has_ivf and methods & SearchMethod.TI:
            return "ivf"
        backend = "lut" if quantized else "decoded"
    if backend in ("decoded", "decoded8", "codes", "ivf"):
        return backend
    if backend == "lut" and on_cuda and max_bits <= 8 and codes_br is not None:
        return "lut_codes"
    if backend == "fast4":
        if max_bits > 4:
            raise ConfigError(
                "fast4 backend requires max_bits <= 4 (reference constraint, "
                "VAQ.cpp:1263-1266)")
        return "fast4"
    if backend != "lut_gather" and on_cuda and max_bits <= 8 and \
            n_rows >= 64 * k and (backend == "lut"
                                  or bool(methods & SearchMethod.FAST)):
        return "fast4"
    return "lut_gather"


def _fast4_block_rows(n_rows: int, k: int) -> int:
    """Window size of the FAST scan (vaq_tpu/vaq.py:771-772): the power of 2
    at or below max(256, min(512, n // (64·k)))."""
    br = max(256, min(512, n_rows // (64 * k)))
    return 1 << (br.bit_length() - 1)


def _learn_quantization_device(luts: torch.Tensor, valid: torch.Tensor,
                               counts: torch.Tensor, alphas: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """α-grid LUT-quantization search on the LUTs' device
    (vaq_tpu/vaq.py:72-121).

    luts (S, M, C) f32 sampled LUTs; valid (M, C) bool, the live centroid
    entries; counts (M,) int32 live centroids per subspace; alphas (A,) f32.
    Returns (offsets (A, M), scales (A, M), losses (A,)). One sort per
    subspace gives every α's offset and ceiling by linearly interpolated
    quantiles (numpy's rule; ``max(col − off, 0)`` keeps the order, so the
    ceiling reads the same sorted column); the losses are summed over blocks
    of 1024 sampled LUTs, zero-padded as in JAX.
    """
    s_n, m, c = luts.shape
    flat = torch.where(valid[None], luts, torch.inf)
    srt = torch.sort(flat.transpose(0, 1).reshape(m, s_n * c), dim=1).values
    nval = (counts * s_n).to(torch.float32)                 # (M,)

    def interp(pos):                                        # pos (A, M)
        lo = torch.floor(pos).to(torch.int32)
        hi = torch.minimum(lo + 1, (nval[None, :] - 1).to(torch.int32))
        w = pos - lo

        def gather(idx):
            return torch.gather(srt, 1, idx.T.to(torch.int64)).T

        return gather(lo), gather(hi), w

    vlo, vhi, w = interp(alphas[:, None] * (nval[None, :] - 1.0))
    off = vlo * (1.0 - w) + vhi * w                         # (A, M)
    vlo, vhi, w = interp((1.0 - alphas)[:, None] * (nval[None, :] - 1.0))
    ceil = (torch.clamp_min(vlo - off, 0.0) * (1.0 - w)
            + torch.clamp_min(vhi - off, 0.0) * w)
    scales = 255.0 / torch.clamp_min(ceil, 1e-30)

    pad = (-s_n) % _LUT_LOSS_BLOCK
    luts_p = torch.nn.functional.pad(torch.where(valid[None], luts, 0.0),
                                     (0, 0, 0, 0, 0, pad))
    losses = torch.zeros_like(alphas)
    for start in range(0, s_n + pad, _LUT_LOSS_BLOCK):
        lm = luts_p[start:start + _LUT_LOSS_BLOCK]
        off_l = torch.clamp_min(lm[None] - off[:, None, :, None], 0.0)
        scaled = off_l * scales[:, None, :, None]
        q8 = torch.clamp_max(torch.floor(scaled), 255.0)
        err = (scaled - q8) * valid[None, None]
        losses = losses + torch.sum(err * err, dim=(1, 2, 3))
    return off, scales, losses


def _encode_blocked(xp: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes for all rows, per subspace.

    xp (n, M·L) projected rows; centroids (M, C, L) padded, f32, same device.
    Returns (n, M) int64 codes; argmin ties go to the lower centroid, as in
    JAX. The argmin stays in f32: padded rows hold PAD_SENTINEL, whose
    ‖c‖² ≈ 1e36 must stay finite (it would overflow an f16 score).
    """
    n = xp.shape[0]
    m, c, l = centroids.shape
    block_rows = min(ENCODE_BLOCK_ROWS, max(1, ENCODE_BLOCK_ELEMS // (m * c)))
    c2 = torch.sum(centroids * centroids, dim=2)          # (M, C)
    cent_t = centroids.transpose(1, 2)                     # (M, L, C)
    codes = torch.empty((n, m), dtype=torch.int64, device=xp.device)
    for start in range(0, n, block_rows):
        blk = xp[start:start + block_rows].reshape(-1, m, l)
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
    device: torch.device | str = DEFAULT

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

    # int8 tier (per-dim scales, exact f32 norms), rebuilt lazily.
    decoded8: Optional[torch.Tensor] = None        # (n, M'·L) int8
    decoded8_scales: Optional[torch.Tensor] = None  # (M'·L,) f32
    decoded8_norms: Optional[torch.Tensor] = None   # (n,) f32

    # Cluster-probe (TI) state, set by ivf.attach_ivf.
    ivf: Optional[object] = None

    # LUT u8 quantization (learn_quantization), one (offset, scale) per
    # subspace; the FAST search quantizes its LUTs with them.
    lut_offsets: Optional[np.ndarray] = None
    lut_scales: Optional[np.ndarray] = None

    # Tombstoned row ids (set by delete(), saved and loaded with the npz).
    deleted_ids: Optional[np.ndarray] = None

    # Device-side caches (not persisted).
    _ev_dev: Optional[torch.Tensor] = None
    _deleted_dev: Optional[torch.Tensor] = None
    _dec_table: Optional[torch.Tensor] = None
    _dec_rows: Optional[torch.Tensor] = None

    # Mesh-sharded tiers (shard()); parallel.sharded.ShardedRows each.
    _mesh: Optional[object] = None
    _q_axis: Optional[str] = None
    _sharded_decoded: Optional[object] = None
    _sharded_norms: Optional[object] = None
    _sharded_decoded8: Optional[object] = None
    _sharded_d8_norms: Optional[object] = None
    _sharded_codes: Optional[object] = None
    _sharded_ivf: Optional[object] = None               # ivf.ShardedIVF

    def __post_init__(self):
        self.device = resolve(self.device)

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def total_dim(self) -> int:
        """Dims actually used for ADC = M' · L (VAQ.cpp:336)."""
        return self.highest_subs * self.subs_len

    @property
    def padded_dim(self) -> int:
        return self.config.subspace_num * self.subs_len

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
        t0 = time.perf_counter()
        x_train = self._train_rotation(x_train)
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
        # count, sample size) train as one batched k-means; >8-bit subspaces
        # of a hierarchical or binary-split config, and groups over the
        # device budget, train one at a time, in JAX's branch order.
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
            if (cfg.hierarchical_kmeans or cfg.binary_kmeans) and \
                    bits[s] > STANDARD_BITS:
                special.append(s)
            else:
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
            sub_s = project_sample(s, samp_of(s))
            if cfg.hierarchical_kmeans and bits[s] > STANDARD_BITS:
                c = kmeans.hierarchical_fit(sub_s, int(bits[s]),
                                            iters=cfg.kmeans_iters,
                                            seed=cfg.seed + s)
            elif cfg.binary_kmeans and bits[s] > STANDARD_BITS:
                c = kmeans.binary_split_fit(sub_s, int(bits[s]),
                                            iters=cfg.kmeans_iters,
                                            seed=cfg.seed + s)
            else:
                c, _ = kmeans.fit(sub_s, k, iters=cfg.kmeans_iters,
                                  seed=cfg.seed + s)
            centroids[s, :k] = c.cpu().numpy()
        self.centroids = centroids
        if verbose:
            print(f"== codebooks: {time.perf_counter() - t0:.3f}s")
        return self

    def _train_rotation(self, x_train: np.ndarray) -> np.ndarray:
        """PCA rotation and truncation from ``x_train`` on the index's
        device; returns the rows zero-padded to the subspaces."""
        cfg = self.config
        self.orig_dim = x_train.shape[1]
        x_train = io.pad_dims(x_train, cfg.subspace_num)
        rot = pca.train_rotation(x_train, cfg.subspace_num,
                                 cfg.percent_var_explained, cfg.seed,
                                 device=self.device)
        self.eigvecs = rot.eigvecs
        self.eigvals = rot.eigvals
        self.var_per_subs = rot.var_per_subs
        self.cum_var_per_subs = rot.cum_var_per_subs
        self.subs_len = rot.subs_len
        self.highest_subs = rot.highest_subs
        self._ev_dev = None
        self._dec_table = self._dec_rows = None
        return x_train

    def build(self, x: np.ndarray, verbose: bool = False) -> "VAQIndex":
        """train + encode."""
        self.train(x, verbose=verbose)
        return self.encode(x, verbose=verbose)

    # ------------------------------------------------------------------
    # Encode — row chunks go to the device one at a time, so device memory
    # stays O(chunk) + O(codes).
    # ------------------------------------------------------------------
    def encode(self, x: np.ndarray, verbose: bool = False,
               chunk_rows: int = ENCODE_CHUNK_ROWS) -> "VAQIndex":
        """Encode host rows (vaq_tpu/vaq.py:329-337), ``chunk_rows`` at a
        time, through :meth:`encode_chunks`."""
        x = io.pad_dims(np.asarray(x, dtype=np.float32),
                        self.config.subspace_num)

        def chunk_fn(i):
            return x[i * chunk_rows:(i + 1) * chunk_rows]

        return self.encode_chunks(chunk_fn, x.shape[0], chunk_rows,
                                  verbose=verbose)

    def encode_chunks(self, chunk_fn, n: int,
                      chunk_rows: int = ENCODE_CHUNK_ROWS,
                      verbose: bool = False) -> "VAQIndex":
        """Encode from an arbitrary chunk source (vaq_tpu/vaq.py:339-378).

        ``chunk_fn(i)`` returns chunk ``i`` (rows ``i·chunk_rows`` on, at
        most ``chunk_rows`` of them) as a (rows_i, d) f32 host or device
        array: a memmap slice, a tensor already on the card. Codes are
        written into one preallocated row-major (n, M') buffer, so device
        memory stays O(chunk) + O(codes). Resets the decoded tiers and the
        probe state and every sharded tier, which described the old
        codes."""
        if self.centroids is None:
            raise NotReadyError("encode() requires train() first")
        t0 = time.perf_counter()
        cent_dev = torch.as_tensor(self.centroids, device=self.device)
        codes = torch.empty((n, self.highest_subs), dtype=self._codes_dtype(),
                            device=self.device)
        for i, start in enumerate(range(0, n, chunk_rows)):
            chunk = self._encode_rows(chunk_fn(i), cent_dev)
            codes[start:start + chunk.shape[0]] = chunk
        self.codes = codes
        self.n_rows = n
        self.decoded = None
        self.decoded_norms = None
        self.decoded8 = self.decoded8_scales = self.decoded8_norms = None
        self.ivf = None
        self._release_shards()
        if verbose:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"== encode {n} rows: {time.perf_counter() - t0:.3f}s")
        return self

    def _encode_rows(self, rows, cent_dev: torch.Tensor) -> torch.Tensor:
        """Codes of (r, d) f32 rows, host or device: zero-padded to the
        rotation's width (io.pad_dims's pad, on the device), projected and
        assigned to the nearest centroid of each subspace."""
        ev_dev = self._eigvecs_device()
        rows = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        if rows.shape[1] < ev_dev.shape[0]:
            rows = torch.nn.functional.pad(
                rows, (0, ev_dev.shape[0] - rows.shape[1]))
        return _encode_blocked(pca.project(rows, ev_dev),
                               cent_dev).to(self._codes_dtype())

    def _codes_dtype(self) -> torch.dtype:
        """u8 when every subspace fits, else int32 (the JAX package's u16 has
        no arithmetic in torch); :meth:`_host_codes` gives JAX's dtype back
        wherever codes leave the index."""
        return torch.uint8 if int(self.bits.max()) <= 8 else torch.int32

    def _device_codes(self, codes: np.ndarray) -> torch.Tensor:
        """Host codes of either package's dtype (u8, u16, int) on the
        device in :meth:`_codes_dtype`."""
        codes = np.asarray(codes)
        if codes.dtype != np.uint8:
            codes = codes.astype(np.int32)
        return torch.as_tensor(np.ascontiguousarray(codes),
                               device=self.device).to(self._codes_dtype())

    def _host_codes(self, codes: torch.Tensor) -> np.ndarray:
        """Codes as the JAX package holds them: u8, u16 up to 16 bits, else
        int32."""
        out = codes.cpu().numpy()
        if out.dtype != np.uint8:
            out = out.astype(np.uint16 if int(self.bits.max()) <= 16
                             else np.int32)
        return out

    def codes_rowmajor(self) -> np.ndarray:
        """Host copy of the (n, M') codes, in the JAX package's dtype."""
        return self._host_codes(self.codes)

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
        exactly; ids outside the rows name no row, as in ``delete``."""
        if self.deleted_ids is not None and len(self.deleted_ids):
            ids = self._deleted_device().to(torch.int64)
            norms[ids[(ids >= 0) & (ids < norms.shape[0])]] = torch.inf
        return norms

    def _ensure_decoded(self) -> None:
        """Materialize the decoded bf16 database for the decoded tier."""
        if self.decoded is None:
            dec, norms = scan_decoded.decode_db(
                self.codes, torch.as_tensor(self.centroids,
                                            device=self.device))
            self.decoded = dec
            self.decoded_norms = self._tombstone_norms(norms)

    def _ensure_decoded8(self) -> None:
        """Materialize the int8 database for the decoded8 tier."""
        if self.decoded8 is None:
            d8, scales, norms = scan_decoded.decode_db_int8(
                self.codes, torch.as_tensor(self.centroids,
                                            device=self.device))
            self.decoded8 = d8
            self.decoded8_scales = scales
            self.decoded8_norms = self._tombstone_norms(norms)

    def _require_codes_bits(self) -> None:
        """The codes tier reads u8 codes, so it serves only ≤ 8-bit
        subspaces; asking for it on a wider index fails loudly instead of
        truncating codes."""
        if int(self.bits.max()) > 8:
            raise ConfigError(
                "backend='codes' supports <= 8-bit subspaces (codes must fit "
                f"u8). This index allocates up to {int(self.bits.max())} bits "
                "— use backend='decoded' or cap the config at max8.")

    def _codes_block_rows(self, k: int, rows: Optional[int] = None
                          ) -> Optional[int]:
        """Window size for the codes tier, unchanged from the JAX version
        (vaq.py:506-528, and :1037-1039 for a shard): the window size decides
        which candidates survive, so changing it changes results.

        The window scan keeps one candidate per (query, window), so recall
        needs windows ≫ k: aim for ≥ 64 windows per requested neighbour,
        floor at 16 rows, cap at 512. ``rows`` is what one scan covers: the
        whole index by default, a shard's rows on a mesh. Returns None when
        even 16-row windows cannot give 64·k windows over the whole index —
        the caller serves the decoded tier then (the same ADC quantity, and
        the decoded db is tiny at such n) — unless the decoded db would
        exceed ~1 GB; a shard always takes windows (16 rows at least)."""
        br = (self.n_rows if rows is None else rows) // (64 * k)
        if br < 16:
            if rows is not None or \
                    self.n_rows * self.total_dim * 2 > (1 << 30):
                return 16
            return None
        return 1 << (min(br, 512).bit_length() - 1)

    def _live_fetch(self, k: int) -> int:
        """How many the codes tier fetches for k live answers: it has no
        norms to poison, so it over-fetches k + #deleted and
        :meth:`_drop_deleted` filters by id on the device."""
        n_del = 0 if self.deleted_ids is None else len(self.deleted_ids)
        return min(k + n_del, self.n_rows)

    def _drop_deleted(self, d: torch.Tensor, i: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The k lowest live entries of a codes-tier answer fetched with
        :meth:`_live_fetch` (tie-exact, as JAX's ``lax.top_k``); dead ids
        become (inf, -1)."""
        if self.deleted_ids is None or len(self.deleted_ids) == 0:
            return d[:, :k], i[:, :k]
        dead = torch.isin(i, self._deleted_device().to(i.device))
        d = torch.where(dead, torch.inf, d)
        i = torch.where(dead, -1, i)
        top, pos = scan_codes._select_lowest(d, k)
        i = torch.gather(i, 1, pos)
        return top, torch.where(torch.isfinite(top), i, -1)

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
        "decoded", "decoded8" or "codes"; the LUT backends raise ConfigError
        here and run through ``search`` (the JAX ``search_device`` serves
        the decoded tier for them instead, vaq_tpu/vaq.py:486-489). Returns
        (sq_dists (nq, k) f32 ascending, labels (nq, k) int32). When the
        index was ``shard()``-ed, the mesh-sharded scan serves the tier, and
        a tier that was not sharded raises ConfigError."""
        if backend not in ("decoded", "decoded8", "codes"):
            if backend in BACKENDS:
                raise ConfigError(
                    f"search_device serves 'decoded', 'decoded8' and "
                    f"'codes'; backend {backend!r} runs through search()")
            raise ConfigError(f"unknown backend {backend!r}")
        if self._mesh is not None:
            sharded_tier = {"decoded": self._sharded_decoded,
                            "decoded8": self._sharded_decoded8,
                            "codes": self._sharded_codes}[backend]
            if sharded_tier is None:
                raise ConfigError(
                    f"index is sharded but tier {backend!r} was not "
                    "included in shard(tiers=...) — serving it unsharded "
                    "would silently ignore the mesh; re-shard with tiers "
                    "including it")
            return self._search_device_sharded(queries_dev, k, backend)
        if backend == "codes":
            self._require_codes_bits()
            br = self._codes_block_rows(k)
            if br is None:
                backend = "decoded"
            else:
                dec_table, dec_rows = self._codes_tier()
                qp = pca.project(queries_dev, self._eigvecs_device())
                return self._drop_deleted(*scan_codes.decode_scan_topk(
                    self.codes, dec_table, dec_rows, qp, self._live_fetch(k),
                    block_rows=br), k)
        if backend == "decoded8":
            self._ensure_decoded8()
            return scan_decoded.decoded8_scan_topk(
                self.decoded8, self.decoded8_scales, self.decoded8_norms,
                pca.project(queries_dev, self._eigvecs_device()), k)
        self._ensure_decoded()
        return scan_decoded.decoded_search_e2e(
            queries_dev, self._eigvecs_device(), self.decoded,
            self.decoded_norms, k)

    def search(self, queries: np.ndarray, k: int, query_batch: int = 512,
               block_rows: int = 32768, backend: str = "auto",
               verbose: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """ADC top-k search for a query batch; host arrays in and out.

        Returns (sq_dists (nq, k) f32, labels (nq, k) int32), ascending.
        backend: "decoded" (bf16 reconstruction GEMM), "decoded8" (the int8
        tier), "codes" (only the u8 codes resident, searched by the CUDA
        kernels K1/K2), "ivf" (the cluster probe, kernels K5/K7; needs
        ``attach_ivf`` first), "fast4" (the FAST window scan, kernel K3, or
        K4 on the u8-quantized LUTs once ``learn_quantization`` has run; the
        reference's ≤ 4-bit constraint), "lut_gather" (the LUT gather scan,
        ``block_rows`` rows at a time), "lut" (the codes tier on the card
        when enough windows form, else "fast4" on the card, else the gather
        scan) or "auto" ("ivf" for TI with probe state, "lut" for a
        quantized FAST-family config, else "decoded"): :func:`_lut_route`,
        JAX's rule (vaq_tpu/vaq.py:587-819) with JAX's accelerator read as
        this index's CUDA device. On a quantized FAST-family config the LUT
        paths use the quantized-then-dequantized tables (FAST3 only on its
        ≤ 4-bit subspaces), as JAX does. Tombstones present when the probe
        buckets were built never come back from the probe; the LUT paths
        over-fetch k + #deleted and drop them on the host. ``verbose``
        prints the batch loop's time and QPS, as JAX does.
        """
        cfg = self.config
        if self.eigvecs is None:
            raise NotReadyError("search() requires train() first")
        if self.codes is None:
            raise NotReadyError("search() requires encode() first")
        n_del = 0 if self.deleted_ids is None else len(self.deleted_ids)
        k_lut = min(k + n_del, self.n_rows) if n_del else k
        quantized = bool(cfg.methods & _FAST_FAMILY) and \
            self.lut_offsets is not None
        route = _lut_route(backend, cfg.methods, int(self.bits.max()),
                           self.n_rows, k_lut, self._codes_block_rows(k_lut),
                           quantized, self.device.type == "cuda",
                           self.ivf is not None)
        if route == "ivf" and self.ivf is None:
            raise NotReadyError(
                "backend='ivf' requires ivf.attach_ivf(index) first")
        if route == "ivf" and self._mesh is not None and \
                self._sharded_ivf is None:
            raise ConfigError(
                "index is sharded but the TI/IVF tier was not included in "
                "shard(tiers=...) — serving the unsharded probe state would "
                "silently ignore the mesh; re-shard with tiers including "
                "'ivf'")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ShapeError(f"queries must be (nq, d), got {queries.shape}")
        if queries.shape[1] > self.eigvecs.shape[0] or \
                (self.orig_dim and queries.shape[1] != self.orig_dim):
            raise ShapeError(
                f"query dim {queries.shape[1]} does not match index dim "
                f"{self.orig_dim}")
        queries = io.pad_dims(queries, cfg.subspace_num)
        k_run = k_lut if route in LUT_ROUTES else k
        nq = queries.shape[0]
        all_d = np.empty((nq, k_run), dtype=np.float32)
        all_i = np.empty((nq, k_run), dtype=np.int32)
        t0 = time.perf_counter()
        for start in range(0, nq, query_batch):
            qb = torch.as_tensor(queries[start:start + query_batch],
                                 device=self.device)
            if route == "ivf" and self._sharded_ivf is not None:
                d, i = self._sharded_ivf.search(
                    pca.project(qb, self._eigvecs_device()), k)
            elif route == "ivf":
                d, i = self.ivf.search(
                    self, pca.project(qb, self._eigvecs_device()), k)
            elif route in LUT_ROUTES:
                d, i = self._lut_search(qb, k_run, route, quantized,
                                        block_rows)
            else:
                d, i = self.search_device(qb, k, backend=route)
            all_d[start:start + qb.shape[0]] = d.cpu().numpy()
            all_i[start:start + qb.shape[0]] = i.cpu().numpy()
        if verbose:
            dt = time.perf_counter() - t0
            print(f"== search {nq} queries: {dt:.3f}s ({nq / dt:.1f} QPS)")
        if k_run > k:
            return self._drop_tombstones(all_d, all_i, k)
        return all_d, all_i

    def _search_luts(self, qp: torch.Tensor, quantized: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(f32 LUTs the LUT paths sum, u8 LUTs for K4 or None) of a
        projected query batch (vaq_tpu/vaq.py:728-750). Quantized: the
        tables go through u8 and back, so the search sees the quantization
        error the reference's shuffle scan sees; FAST3 applies it only to
        its ≤ 4-bit subspaces and keeps f32 winner selection, other FAST
        configs select on the raw u8 sums."""
        luts = scan_lut.build_luts(
            qp, torch.as_tensor(self.centroids, device=self.device))
        if not quantized:
            return luts, None
        off = torch.tensor(self.lut_offsets, dtype=torch.float32,
                           device=self.device)
        scales = torch.tensor(self.lut_scales, dtype=torch.float32,
                              device=self.device)
        lut8 = scan_lut.quantize_luts(luts, off, scales)
        deq = (lut8.to(torch.float32) / scales[None, :, None]
               + off[None, :, None])
        if self.config.methods & SearchMethod.FAST3:
            shuf = torch.as_tensor(self.bits <= 4, device=self.device)
            return torch.where(shuf[None, :, None], deq, luts), None
        return deq, lut8

    def _lut_search(self, qb: torch.Tensor, k: int, route: str,
                    quantized: bool, block_rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One query batch down a LUT route of :func:`_lut_route`."""
        if route == "lut_codes":
            qp = pca.project(qb, self._eigvecs_device())
            dec_table, dec_rows = self._codes_tier()
            return scan_codes.decode_scan_topk(
                self.codes, dec_table, dec_rows, qp, k,
                block_rows=self._codes_block_rows(k))
        with record_function("fast.lut"):  # projection, LUTs, quantization
            qp = pca.project(qb, self._eigvecs_device())
            luts, lut8 = self._search_luts(qp, quantized)
            padc = 16 - luts.shape[2]
            if route != "lut_gather" and padc > 0:
                # max_bits < 4: pad the tables to C = 16 with zeros, never
                # inf (JAX's one-hot matmul turned 0·inf into NaN); codes
                # stay < 2^bits, so the padded entries are never read
                luts = torch.nn.functional.pad(luts, (0, padc))
                if lut8 is not None:
                    lut8 = torch.nn.functional.pad(lut8, (0, padc))
        if route == "lut_gather":
            return scan_lut.adc_scan_topk(self.codes, luts, k,
                                          block_rows=block_rows)
        return scan_codes.fast4_scan_topk(
            self.codes, luts, k,
            block_rows=_fast4_block_rows(self.n_rows, k), luts8=lut8)

    def _drop_tombstones(self, all_d: np.ndarray, all_i: np.ndarray, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Strip tombstoned ids from an over-fetched result and keep the
        first k survivors of each row (vaq_tpu/vaq.py:807-818): a stable
        argsort on the dead mask moves the live entries to the front in
        their order."""
        dead = np.isin(all_i, self.deleted_ids)
        order = np.argsort(dead, axis=1, kind="stable")
        d_s = np.take_along_axis(all_d, order, axis=1)[:, :k]
        i_s = np.take_along_axis(all_i, order, axis=1)[:, :k]
        n_live = all_i.shape[1] - dead.sum(axis=1)
        valid = np.arange(k)[None, :] < n_live[:, None]
        return (np.where(valid, d_s, np.inf).astype(np.float32),
                np.where(valid, i_s, -1).astype(np.int32))

    # ------------------------------------------------------------------
    # CRUD (reference get/append/deleteBitV, BitVecEngine.cpp:1626-1636)
    # ------------------------------------------------------------------
    def add(self, x_new: np.ndarray) -> np.ndarray:
        """Encode + append rows; returns their new global ids
        (vaq_tpu/vaq.py:824-854). A resident decoded tier grows by the new
        rows; the int8 tier is dropped and rebuilt lazily. The probe buckets
        stay as they were, as in JAX: the IVF path never returns an added
        row until ``attach_ivf`` runs again. Every sharded tier is released
        (``shard`` again after adds)."""
        if self.codes is None:
            raise NotReadyError("add() requires encode() first")
        cent_dev = torch.as_tensor(self.centroids, device=self.device)
        new_codes = self._encode_rows(np.asarray(x_new, dtype=np.float32),
                                      cent_dev)
        start = self.n_rows
        self.codes = torch.cat([self.codes, new_codes])
        self.n_rows += new_codes.shape[0]
        if self.decoded is not None:
            dec, norms = scan_decoded.decode_db(new_codes, cent_dev)
            self.decoded = torch.cat([self.decoded, dec])
            self.decoded_norms = torch.cat([self.decoded_norms, norms])
        self.decoded8 = self.decoded8_scales = self.decoded8_norms = None
        self._release_shards()
        return np.arange(start, self.n_rows)

    def delete(self, ids) -> None:
        """Tombstone rows: they stop appearing in results
        (vaq_tpu/vaq.py:856-924). The decoded tiers exclude them exactly by
        +inf norms, set here on every resident tier and again on any
        rebuild; the probe by ``bucket_ids == -1``, its buckets poisoned
        here (``ivf.poison_deleted``); the codes and LUT paths over-fetch
        and filter by id in ``search``. The sharded tiers get the same:
        +inf on the sharded norms, poison in the sharded buckets."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if self.deleted_ids is None:
            self.deleted_ids = np.unique(ids)
        else:
            self.deleted_ids = np.unique(
                np.concatenate([self.deleted_ids, ids]))
        self._deleted_dev = None  # re-uploaded lazily by _deleted_device
        dev_ids = torch.as_tensor(ids[(ids >= 0) & (ids < self.n_rows)],
                                  device=self.device)
        if self.decoded is not None:
            self.decoded_norms[dev_ids] = torch.inf
        if self.decoded8 is not None:
            self.decoded8_norms[dev_ids] = torch.inf
        if self.ivf is not None:
            poison_deleted(self.ivf.state, dev_ids)
        # the sharded tiers likewise: +inf norms, poisoned probe buckets
        live = ids[(ids >= 0) & (ids < self.n_rows)]
        for norms in (self._sharded_norms, self._sharded_d8_norms):
            if norms is not None:
                norms.fill_rows(live, torch.inf)
        if self._sharded_ivf is not None:
            self._sharded_ivf.poison(dev_ids)

    def get_codes(self, ids) -> np.ndarray:
        """Raw codes of rows (the getBitV analog), in the JAX package's
        dtype."""
        sel = torch.as_tensor(np.atleast_1d(ids), dtype=torch.int64,
                              device=self.device)
        return self._host_codes(self.codes[sel])

    def reconstruct(self, ids) -> np.ndarray:
        """Decoded (reconstructed) vectors of rows, f32 (M'·L wide)."""
        codes = self.get_codes(ids).astype(np.int64)
        out = np.empty((codes.shape[0], self.total_dim), dtype=np.float32)
        l = self.subs_len
        for s in range(self.highest_subs):
            out[:, s * l:(s + 1) * l] = self.centroids[s][codes[:, s]]
        return out

    # ------------------------------------------------------------------
    # Serving over a mesh: the tiers sharded by rows (vaq.py:947-1058)
    # ------------------------------------------------------------------
    def shard(self, mesh=None, q_axis: Optional[str] = None,
              tiers: Tuple[str, ...] = ("decoded",)) -> "VAQIndex":
        """Row-shard database tiers over the mesh's "db" axis
        (``parallel.make_mesh()``, every visible card, by default).

        ``tiers`` selects which tiers get a sharded path: "decoded" (bf16,
        2·D B/row), "decoded8" (int8, D B/row), "codes" (the raw codes, M
        B/row; kernels K1/K2 per shard) and/or "ivf" (the probe buckets,
        sharded by whole clusters; requires ``attach_ivf`` first; kernels
        K5/K7 per shard). After this, ``search_device``/``search`` with a
        matching backend run the sharded scan, each shard's top-k merged on
        the mesh's first device; a backend whose tier was NOT sharded
        raises instead of silently serving unsharded. The sharded decoded
        tier also gives the sharded int8 probe its exact second stage. Pass
        ``q_axis="q"`` on a 2-D ("q", "db") mesh to split the queries.

        Every sharded tier lives on the mesh of the last call: tiers that an
        earlier call sharded are laid out again on this mesh (a tier's parts
        follow the mesh they were split for, and the searches walk the
        index's one mesh), so their answers are this mesh's. (JAX leaves
        them on the earlier mesh's devices, and its search refuses them.)"""
        from vaq_tpu_torch.parallel import make_mesh
        from vaq_tpu_torch.parallel.sharded import split_rows

        unknown = set(tiers) - {"decoded", "decoded8", "codes", "ivf"}
        if unknown:
            raise ConfigError(f"unknown shard tiers: {sorted(unknown)}")
        if "ivf" in tiers and self.ivf is None:
            raise ConfigError(
                "shard tier 'ivf' requires attach_ivf() first (the probe "
                "state to shard)")
        if "codes" in tiers:
            self._require_codes_bits()
        mesh = mesh if mesh is not None else make_mesh()
        tiers = set(tiers) | self._sharded_tiers()
        self._release_shards()
        if "decoded" in tiers:
            self._ensure_decoded()
            self._sharded_decoded = split_rows(self.decoded, mesh)
            self._sharded_norms = split_rows(self.decoded_norms, mesh,
                                             fill=torch.inf)
        if "ivf" in tiers:
            from vaq_tpu_torch.ivf import ShardedIVF
            self._sharded_ivf = ShardedIVF(
                self.ivf.state, self.ivf.visit, mesh, q_axis,
                rescore_rows=self._sharded_decoded,
                rescore_norms=self._sharded_norms)
        if "decoded8" in tiers:
            self._ensure_decoded8()
            self._sharded_decoded8 = split_rows(self.decoded8, mesh)
            self._sharded_d8_norms = split_rows(self.decoded8_norms, mesh,
                                                fill=torch.inf)
        if "codes" in tiers:
            self._codes_tier()  # the (small, replicated) decode tables
            self._sharded_codes = split_rows(self.codes, mesh)
        self._mesh = mesh
        self._q_axis = q_axis
        return self

    def _sharded_tiers(self) -> set:
        """The names of the tiers that are sharded now."""
        return {name for name, part in (
            ("decoded", self._sharded_decoded),
            ("decoded8", self._sharded_decoded8),
            ("codes", self._sharded_codes), ("ivf", self._sharded_ivf))
            if part is not None}

    def _release_shards(self) -> None:
        """Drop the mesh and every sharded buffer (after the rows change;
        ``shard`` again to serve sharded)."""
        self._mesh = self._q_axis = None
        self._sharded_decoded = self._sharded_norms = None
        self._sharded_decoded8 = self._sharded_d8_norms = None
        self._sharded_codes = self._sharded_ivf = None

    def _search_device_sharded(self, queries_dev: torch.Tensor, k: int,
                               backend: str = "decoded"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        from vaq_tpu_torch.parallel import (sharded_codes_search,
                                            sharded_decoded8_search,
                                            sharded_decoded_search)

        qp = pca.project(queries_dev, self._eigvecs_device())
        if backend == "decoded":
            return sharded_decoded_search(
                self._sharded_decoded, self._sharded_norms, qp, k,
                self.n_rows, self._mesh, q_axis=self._q_axis)
        if backend == "decoded8":
            return sharded_decoded8_search(
                self._sharded_decoded8, self.decoded8_scales,
                self._sharded_d8_norms, qp, k, self.n_rows, self._mesh,
                q_axis=self._q_axis)
        # codes tier: a shard's rows set the window size; tombstones are
        # filtered by id after the merge, as on the unsharded codes path
        dec_table, dec_rows = self._codes_tier()
        return self._drop_deleted(*sharded_codes_search(
            self._sharded_codes, dec_table, dec_rows, qp, self._live_fetch(k),
            self.n_rows, self._mesh,
            block_rows=self._codes_block_rows(
                k, self._sharded_codes.shard_rows),
            q_axis=self._q_axis), k)

    # ------------------------------------------------------------------
    # LUT quantization (V16)
    # ------------------------------------------------------------------
    def learn_quantization(self, x_train: np.ndarray,
                           sample_ratio: float = 0.1) -> "VAQIndex":
        """Learn the per-subspace u8 LUT offset and scale by the α-grid
        search (reference VAQ.cpp:1118-1187; vaq_tpu/vaq.py:543-582), on the
        index's device: LUTs of a seeded sample of ``sample_ratio`` of the
        rows (at most 65,536), padded centroid entries masked out; the last
        α whose loss is at or below the minimum wins, as in the reference.
        """
        if self.centroids is None:
            raise NotReadyError("learn_quantization() requires train() first")
        cfg = self.config
        dev = self.device
        x_train = io.pad_dims(np.asarray(x_train, dtype=np.float32),
                              cfg.subspace_num)
        sample_n = min(max(1, int(sample_ratio * x_train.shape[0])),
                       LUT_SAMPLE_CAP)
        qs = rng.sample_rows(x_train, sample_n, cfg.seed)
        qp = pca.project(torch.as_tensor(qs, device=dev),
                         self._eigvecs_device())
        luts = scan_lut.build_luts(
            qp, torch.as_tensor(self.centroids, device=dev))
        valid = torch.as_tensor(np.arange(self.max_centroids)[None, :]
                                < self.centroid_counts[:, None], device=dev)
        offs, scales, losses = _learn_quantization_device(
            luts, valid,
            torch.as_tensor(self.centroid_counts.astype(np.int32), device=dev),
            torch.tensor(LUT_ALPHAS, dtype=torch.float32, device=dev))
        losses = losses.cpu().numpy()
        best = int(np.flatnonzero(losses <= losses.min())[-1])
        self.lut_offsets = offs[best].cpu().numpy()
        self.lut_scales = scales[best].cpu().numpy()
        return self

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
            arrays["codes"] = self.codes_rowmajor()
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

    def export_reference_artifacts(self, centroids_path: str,
                                   codes_path: str) -> None:
        """Write centroids/codes in the C++ reference's binary formats
        (saveCentroids/saveCodebook; vaq_tpu/vaq.py:1113-1120), codes as
        the format's u16."""
        cents = [self.centroids[s, : int(self.centroid_counts[s])]
                 for s in range(self.highest_subs)]
        io.save_centroids_ref(centroids_path, cents)
        io.save_codebook_ref(codes_path, self.codes_rowmajor())

    @classmethod
    def from_reference_artifacts(cls, config: VAQConfig, centroids_path: str,
                                 codes_path: str, x_train: np.ndarray,
                                 device: torch.device | str = DEFAULT
                                 ) -> "VAQIndex":
        """Build an index on ``device`` from the C++ engine's saved centroids
        + codebook (vaq_tpu/vaq.py:1122-1160).

        The reference does NOT persist the eigenvectors (SURVEY §5), so the
        rotation is retrained from the same training data on ``device``;
        centroids and codes are then adopted as-is.
        """
        idx = cls(config, device=device)
        idx._train_rotation(np.asarray(x_train, dtype=np.float32))
        cents = io.load_centroids_ref(centroids_path)
        idx.highest_subs = min(idx.highest_subs, len(cents))
        counts = np.array([c.shape[0] for c in cents[: idx.highest_subs]],
                          dtype=np.int64)
        idx.bits = np.round(np.log2(counts)).astype(np.int64)
        idx.centroid_counts = counts
        cmax = 1 << int(idx.bits.max())
        full = np.full((idx.highest_subs, cmax, idx.subs_len), PAD_SENTINEL,
                       dtype=np.float32)
        for s, c in enumerate(cents[: idx.highest_subs]):
            full[s, : c.shape[0]] = c
        idx.centroids = full

        codes = io.load_codebook_ref(codes_path)[:, : idx.highest_subs]
        idx.codes = idx._device_codes(codes)
        idx.n_rows = codes.shape[0]
        return idx

    @classmethod
    def load(cls, path: str, device: torch.device | str = DEFAULT,
             with_codes: bool = True) -> "VAQIndex":
        """Load an index saved by either package onto ``device``.
        ``with_codes=False`` skips the device upload of the codes, for flows
        that serve another tier (vaq_tpu/vaq.py:1162-1171)."""
        from vaq_tpu_torch.convert import index_from_numpy

        arrays, meta = io.load_index_npz(path)
        if not with_codes:
            arrays.pop("codes", None)
        return index_from_numpy(arrays, meta, device)
