"""Optional external networks (counterpart of trase_tpu/ext)."""
