"""Dispatchable training entry points (CLI-compatible with the traces)."""
