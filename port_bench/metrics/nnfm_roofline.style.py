"""The NNFM's share of its roofline in the profiled style steps:
4 N1 N2 C operations a call (the similarity and its backward product;
N1, N2 and C from the port's ``nnfm`` counter) at the float32 peak over
the device time of the kernels that the step's ``trase.step.loss`` span
and the backward ops of that span's forward ops launched
(modes/style.py: linked_profile)."""
UNIT = "%"


def read(m):
    if not m or not m.get("regions_s"):
        return None
    t = m["regions_s"].get("nnfm", 0.0)
    if t <= 0 or not m["work"].get("nnfm_bound_s"):
        return None
    return 100.0 * m["work"]["nnfm_bound_s"] / t
