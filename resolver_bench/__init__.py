"""Benchmark of the PyTorch/CUDA resolver (foundationdb_tpu_torch).

run.py is the command; BENCHMARK.json at the checkout's root names the
configurations (configs/), traffic mixes (traffic/) and metric readers
(metrics/) that it finds by name. reference.py is the plain resolver that
decides `correct`; it imports nothing of the program.
"""
