"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit), the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
                  "f32": 67e12}


def bound_s(nbytes: float = 0.0, ops: float = 0.0, kind: str = "bf16"
            ) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def scan_bound_s(nq: int, n: int, dim: int) -> float:
    """The bound of one batch of an exhaustive scan of ``n`` rows of
    ``dim`` dimensions for ``nq`` queries: its bf16 products, ``2 · nq · n
    · dim`` operations (0.2651 ms at 1024 × 1M × 128). It bounds K1, whose
    bytes (n · M codes) count for far less, and D1 alike, so every scan's
    roofline counts one frozen function whatever kernel scans the rows."""
    return bound_s(ops=2.0 * nq * n * dim, kind="bf16")
