"""K1 (csrc/ecs_lif.cu) in the traced serving steps: its bound at the
configuration's site shapes (counts/) over its device time, in %."""
from port_bench.core.readers import roofline


def read(rec):
    return roofline(rec, "k1", "ecs_lif_kernel")
