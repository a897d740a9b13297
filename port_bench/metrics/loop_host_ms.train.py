"""Host time per iteration of the training loop outside the step call:
the mean interval between the loop's on_iteration callbacks over the
window, less the mean host time of a step call (its span, taken around
engine/trainer.py's step function from outside). It includes the GT
fetch and upload on a cache miss and the loop's reads of the step's
metrics, which wait for the device."""
UNIT = "ms"


def read(m):
    if not m or not m.get("iteration_s") or not m.get("step_s"):
        return None
    it = sum(m["iteration_s"]) / len(m["iteration_s"])
    st = sum(m["step_s"]) / len(m["step_s"])
    return (it - st) * 1e3
