"""Command-line entry points of the port's LLM layer."""
