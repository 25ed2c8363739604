"""Host wall ms to issue one training micro-step (make_train_step's step:
the T-loops, the kernel wrappers, the optimizer) with the card idle at its
start and no wait inside it: the median over the traced run's steps after
the profiled sub-window."""
from port_bench.core.readers import median_ms


def read(rec):
    return median_ms(rec.get("host_issue_s"), 1e3)
