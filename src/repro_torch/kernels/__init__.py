"""Hand-written Hopper kernels of the port, each beside its plain version.

threshold_ssum: the circuit-program kernel (CUDA C++, ``csrc/circuit_eval.cu``).
ref: counter oracles.  _build: compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
