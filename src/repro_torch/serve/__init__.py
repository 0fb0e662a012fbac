"""Batched LLM serving of the port (:mod:`.engine`)."""
