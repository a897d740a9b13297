"""Host time per call of the training step (engine/trainer.py:
gaussian_phase_step), without a synchronise: the span the benchmark
wraps around the call, averaged over the window."""
UNIT = "ms"


def read(m):
    if not m or not m.get("step_s"):
        return None
    return sum(m["step_s"]) / len(m["step_s"]) * 1e3
