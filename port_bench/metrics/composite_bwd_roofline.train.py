"""The compositor backward's share of its roofline in the profiled
training steps: the least time for the backward and its per-gaussian
reduce (port_bench/counts/bounds.py: composite_bwd_work) over the device
time of both kernels in the trace."""
UNIT = "%"
KERNELS = ("composite_bwd_kernel", "reduce_pair_grads_kernel")


def read(m):
    if not m:
        return None
    from port_bench.harness import kernel_seconds

    t = kernel_seconds(m["profile"]["by_name"], KERNELS)
    bound_ms = m["work"].get("composite_bwd_bound_ms")
    if t <= 0 or not bound_ms:
        return None
    return 100.0 * sum(bound_ms) * 1e-3 / t
