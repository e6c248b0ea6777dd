"""serve — HTTP search service over a saved VAQ index.

The counterpart of ``vaq_tpu/cli/serve.py``, with its flags, on the card
(``VAQ_TPU_PLATFORM=cpu`` runs it on the CPU). The reference has no serving
surface (its demos are batch CLIs, ``examples/demo_vaq.cpp:19``); this is
the deployment entry point: load an index artifact (or build one from a
synthetic dataset for smoke tests), start the continuous batcher, and expose
``POST /search`` / ``GET /stats`` / ``GET /healthz``.

    python -m vaq_tpu_torch.cli.serve --index index.npz --port 8080 \\
        --k 10 --max-batch 256 --max-wait-ms 2

    curl -s localhost:8080/search -d '{"query": [0.1, ...], "k": 10}'
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--index", default="", help="saved VAQIndex .npz artifact")
    p.add_argument("--synthetic", type=int, default=0,
                   help="build an n-row synthetic index instead (smoke test)")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--method", default="VAQ256m32min7max8var1,HEAP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--backend", default="decoded")
    return p


def main(argv=None, stop: threading.Event | None = None) -> int:
    """Serve until interrupted, or until ``stop`` is set (a caller running
    the service in a thread)."""
    p = build_parser()
    args = p.parse_args(argv)

    import vaq_tpu_torch as vt
    from vaq_tpu_torch.cli import platform_device
    from vaq_tpu_torch.serving import SearchServer
    from vaq_tpu_torch.serving_http import SearchHTTPServer

    device = platform_device()
    if args.index:
        idx = vt.VAQIndex.load(args.index, device=device)
    elif args.synthetic:
        from vaq_tpu_torch.data import make_anisotropic_gaussian

        base, _ = make_anisotropic_gaussian(args.synthetic, args.dim, 1,
                                            seed=7)
        cfg = vt.parse_method_string(args.method)
        idx = vt.VAQIndex(cfg, device=device).build(base, verbose=True)
    else:
        p.error("one of --index / --synthetic is required")

    srv = SearchServer(idx, k=args.k, max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms, backend=args.backend)
    # warm the search path (and build its tiers) before accepting traffic
    srv.search(np.zeros((1, idx.padded_dim), dtype=np.float32))
    http = SearchHTTPServer(srv, host=args.host, port=args.port).start()
    host, port = http.address[:2]
    print(f"serving on http://{host}:{port}  (k={args.k}, "
          f"max_batch={args.max_batch}, backend={args.backend})",
          flush=True)
    try:
        (stop or threading.Event()).wait()
    except KeyboardInterrupt:
        pass
    finally:
        http.close()
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
