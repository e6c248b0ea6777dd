"""The port's sharded search over a process group: two processes joined by
``torch.distributed`` (gloo, the CPU backend; ``file://`` rendezvous under
the test's temporary directory), each holding two CPU shards of a "db" axis
that spans both, must answer exactly as one process holding all four
shards: ``sharded_exact_search``, the sharded codes tier of
``VAQIndex.shard`` and ``lloyd_sharded``. ``pod_mesh(q_hosts=True)`` puts
the "q" axis on the two processes; their query halves come back in query
order. The workers are plain subprocesses (``python -c``), joined within
120 s.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from vaq_tpu_torch import VAQIndex, parse_method_string
from vaq_tpu_torch.parallel import make_mesh, sharded_exact_search
from vaq_tpu_torch.parallel.dist_kmeans import lloyd_sharded, shard_rows_for

torch.set_num_threads(2)  # six test workers share the host

ROOT = Path(__file__).resolve().parent.parent
METHOD = "VAQ64m8min7max8var1,HEAP"
K = 5


def _inputs(tmp: Path):
    """The rows, queries, k-means start and saved index both sides use."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4001, 64)).astype(np.float32)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    return x, q, x[:16].copy(), str(tmp / "index.npz")


def _answers(mesh, x, q, c0, index_path, q_axis=None):
    """(exact d, exact i, codes d, codes i, centroids) over ``mesh``."""
    d, i = sharded_exact_search(shard_rows_for(mesh, x), torch.as_tensor(q),
                                K, x.shape[0], mesh, q_axis=q_axis)
    idx = VAQIndex.load(index_path, device="cpu")
    idx.shard(mesh, q_axis=q_axis, tiers=("codes",))
    cd, ci = idx.search_device(torch.as_tensor(q), K, backend="codes")
    cents = lloyd_sharded(shard_rows_for(mesh, x), torch.as_tensor(c0),
                          x.shape[0], 4, mesh)
    return [a.numpy() for a in (d, i, cd, ci, cents)]


def _worker(rank: int, tmp: str) -> None:
    """One of the two processes: join the group, answer on a "db" axis over
    both (2 CPU shards each), then on pod_mesh's ("q", "db") grid; rank 0
    writes what it got."""
    import torch.distributed as dist

    from vaq_tpu_torch.parallel.multihost import (initialize_distributed,
                                                  pod_mesh)
    torch.set_num_threads(2)  # as this module's: the same GEMM splits
    tmp = Path(tmp)
    initialize_distributed(f"file://{tmp / 'rendezvous'}", 2, rank)
    assert dist.get_backend() == "gloo"
    x, q, c0, path = _inputs(tmp)
    mesh = make_mesh(devices=["cpu", "cpu"], group=dist.group.WORLD)
    assert mesh.shape == {"db": 4} and mesh.offset("db") == 2 * rank
    got = _answers(mesh, x, q, c0, path)
    pod, q_axis = pod_mesh(q_hosts=True, devices=["cpu", "cpu"])
    assert q_axis == "q" and pod.shape == {"q": 2, "db": 2}
    d, i = sharded_exact_search(shard_rows_for(pod, x), torch.as_tensor(q),
                                K, x.shape[0], pod, q_axis="q")
    if rank == 0:
        np.savez(tmp / "ranks.npz", *got, pod_d=d.numpy(), pod_i=i.numpy())
    dist.barrier()
    dist.destroy_process_group()


def test_two_processes_equal_one_with_four_shards(tmp_path):
    x, q, c0, path = _inputs(tmp_path)
    VAQIndex(parse_method_string(METHOD), device="cpu").build(x).save(path)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_multiprocess as t; t._worker({r}, "
         f"{str(tmp_path)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs

    one = _answers(make_mesh(devices=["cpu"] * 4), x, q, c0, path)
    ranks = np.load(tmp_path / "ranks.npz")
    for j, want in enumerate(one):
        np.testing.assert_array_equal(ranks[f"arr_{j}"], want)
    np.testing.assert_array_equal(ranks["pod_i"], one[1])
    np.testing.assert_array_equal(ranks["pod_d"], one[0])
    assert (one[3] >= 0).all()
