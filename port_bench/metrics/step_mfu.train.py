"""The whole training step's share of the card's peak: the step's
counted operations (the deform MLP's forward and backward at the bf16
peak; the compositor's forward and backward, SSIM and the MLP's float32
heads at the float32 peak; port_bench/counts/bounds.py) at those peaks,
over the measured time per iteration of the window (host clock)."""
UNIT = "%"


def read(m):
    if not m or not m.get("window_iterations"):
        return None
    per_it = m["window_s"] / m["window_iterations"]
    return 100.0 * m["work"]["peak_s_per_step"] / per_it
