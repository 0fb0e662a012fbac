"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``csrc/schedule_tick.cu`` (the fused greedy scheduling pass) and
``csrc/waterfill.cu`` (the prefix waterfill) are built by :mod:`.build` at
first use; :mod:`.ref` holds the plain versions the CPU tests use and the
card is checked against.
"""
