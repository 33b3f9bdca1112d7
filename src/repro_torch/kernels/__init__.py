"""Hand-written Hopper kernels of the port, each beside its plain version.

threshold_ssum: the circuit-program kernel (CUDA C++, ``csrc/circuit_eval.cu``).
tiled_scan: the tiled route's block kernel (CUDA C++, ``csrc/tiled_block.cu``)
and its event stage (torch ops).
ops: the deprecated ``fused_*`` shims over the query layer.
ref: counter oracles.  _build: compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
