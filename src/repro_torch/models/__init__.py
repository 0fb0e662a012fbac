"""The port's LLM layer: layers (GQA and MLA attention), the Mamba-2 SSD
block, the MoE layer, the decoder LM of kinds ``mamba`` / ``shared`` /
``attn`` / ``moe``, and prefill / decode."""
