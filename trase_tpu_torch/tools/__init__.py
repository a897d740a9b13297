"""Interop tools of the port (counterpart of trase_tpu/tools)."""
