"""The whole style step's share of the card's peak: the step's counted
operations (VGG16's forward and input gradient, the NNFM's products and
the compositor's forward and backward at the float32 peak, the deform
MLP's forward at the bf16 peak; port_bench/counts/style.py and
bounds.py) at those peaks, over the measured time per iteration of the
window (host clock)."""
UNIT = "%"


def read(m):
    if not m or not m.get("window_iterations"):
        return None
    per_it = m["window_s"] / m["window_iterations"]
    return 100.0 * m["work"]["peak_s_per_step"] / per_it
