"""VGG16's share of its roofline in the profiled style steps: its
counted forward and input-gradient operations through conv4_1 at the
float32 peak (port_bench/counts/style.py: vgg_step_flops) over the
device time of the kernels that the step's ``trase.step.vgg`` span and
the backward ops of that span's forward ops launched (modes/style.py:
linked_profile)."""
UNIT = "%"


def read(m):
    if not m or not m.get("regions_s"):
        return None
    t = m["regions_s"].get("vgg", 0.0)
    if t <= 0:
        return None
    return 100.0 * m["work"]["vgg_bound_s"] / t
