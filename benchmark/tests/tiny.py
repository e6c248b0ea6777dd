"""The benchmark's cells cut to a size a CPU test run can hold: the same
methods, traffic loops and checks, fewer rows and a short window."""

from benchmark.harness.spec import load_cell

SIZES = {"n": 12288, "n_queries": 400, "encode_chunk_rows": 3000}


def cell(workload: str):
    c = load_cell(workload)
    cfg = {**c.config, **SIZES}
    cfg["train_rows"] = min(c.config["train_rows"], 8192
                            if c.config["train_rows"] >= c.config["n"]
                            else 4096)
    if cfg.get("probe"):
        # 1000 clusters and 12-bit codebooks need more rows than a test has
        cfg["method"] = cfg["method"].replace("TI1000", "TI32").replace(
            "max12", "max9")
        cfg["probe"] = {**cfg["probe"], "clusters": 32}
    c.config = cfg
    c.traffic = {**c.traffic, "query_batch": 64}
    return c
