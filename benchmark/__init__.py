"""The benchmark of ``vaq_tpu_torch``: one cell run once by ``run.py``.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own (``configs/``, ``traffic/``,
``layer_metrics/``, ``limits/``), found by the names in ``BENCHMARK.json``.
"""
