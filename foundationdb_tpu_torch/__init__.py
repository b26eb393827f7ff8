"""PyTorch / CUDA port of the resolver's conflict check.

The package runs the ConflictSet contract of ``foundationdb_tpu`` — route,
pack, ``local_phases``, commit fixpoint, apply — on one NVIDIA H100. Plain
tensor code is PyTorch; the commit fixpoint is a CUDA C++ kernel built for
``sm_90a`` from ``csrc/`` at first use (``native/build.py``).

The package imports ``torch``, ``numpy`` and the standard library only.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
