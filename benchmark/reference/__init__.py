"""The plain reference of the benchmark: NumPy and PyTorch only. It imports
nothing of ``vaq_tpu_torch``, ``vaq_tpu`` or JAX, and runs in f64."""
