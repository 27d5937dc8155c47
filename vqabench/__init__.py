"""The benchmark of ``vqa_tpu_torch``, the PyTorch and CUDA port.

``python -m vqabench.run`` runs one cell of ``BENCHMARK.json`` once; see
``vqabench/run.py``. Nothing here imports JAX or the JAX package, and
``vqabench/reference`` imports nothing of the port.
"""
