"""Experiment layer of the port: spec, backend and the CLI entry point."""
