"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``csrc/schedule_tick.cu`` (the fused greedy scheduling pass),
``csrc/waterfill.cu`` (the prefix waterfill), ``csrc/rmsnorm.cu``,
``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` (the LLM layer's
RMSNorm, online-softmax attention and Mamba-2 SSD scan) are built by
:mod:`.build` at first use; :mod:`.ref` holds the plain versions the CPU
tests use and the card is checked against.
"""
