"""Host time per densification round of the training loop
(engine/loop.py: Trainer._densify: the capacity check, a table grown
where the live rows near capacity, clone, split and prune), the span the
benchmark wraps around the call from outside, averaged over the window's
rounds. The call reads the live-row count twice (before the round and
from its stats), and each read waits for the device: the time holds the
drain of the steps queued before it as well as the round's own work."""
UNIT = "ms"


def read(m):
    if not m or not m.get("densify_s"):
        return None
    return sum(m["densify_s"]) / len(m["densify_s"]) * 1e3
