"""The port's LLM layer: layers, the Mamba-2 SSD block, the decoder LM of
kinds ``mamba`` / ``shared`` / ``attn``, and prefill / decode."""
