"""The share of the profiled style stretch in which no operation ran on
the device: 1 - busy / window, busy being the union of the trace's
kernel, copy and set intervals."""
UNIT = "%"


def read(m):
    if not m or m["profile"]["window_s"] <= 0:
        return None
    p = m["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
