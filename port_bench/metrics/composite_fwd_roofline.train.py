"""The compositor forward's share of its roofline in the profiled
training steps: the least time at the card's published peaks for the
work these inputs need (counted by the benchmark's own binning,
port_bench/counts/bounds.py: composite_fwd_work, with residuals) over
the device time of the forward kernel in the trace."""
UNIT = "%"
KERNELS = ("composite_fwd_kernel",)


def read(m):
    if not m:
        return None
    from port_bench.harness import kernel_seconds

    t = kernel_seconds(m["profile"]["by_name"], KERNELS)
    bound_ms = m["work"].get("composite_fwd_bound_ms")
    if t <= 0 or not bound_ms:
        return None
    return 100.0 * sum(bound_ms) * 1e-3 / t
