"""Multi-device / multi-process execution: mesh, sharded scan, distributed
train.

The counterpart of ``vaq_tpu/parallel``. The reference's only parallelism is
OpenMP threads and a disk-resident chunk-scan with per-chunk top-k merge
(``BitVecEngine.cpp:1441-1624``); SURVEY §2.5/§3.5 makes that merge pattern
the blueprint: code rows sharded over a mesh, LUTs replicated, per-shard
top-k merged by one gather of k rows per shard.
"""

from vaq_tpu_torch.parallel.mesh import make_mesh
from vaq_tpu_torch.parallel.sharded import (shard_codes, sharded_adc_search,
                                            sharded_codes_search,
                                            sharded_decoded8_search,
                                            sharded_decoded_search,
                                            sharded_exact_search,
                                            sharded_ivf_search)

__all__ = [
    "make_mesh",
    "shard_codes",
    "sharded_adc_search",
    "sharded_codes_search",
    "sharded_decoded8_search",
    "sharded_decoded_search",
    "sharded_exact_search",
    "sharded_ivf_search",
]
