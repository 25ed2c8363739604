"""K5 (csrc/spread_gemm.cu) in the traced training micro-steps: its bound at
the configuration's site shapes (counts/) over its device time, in %."""
from port_bench.core.readers import roofline


def read(rec):
    return roofline(rec, "k5", "spread_gemm")
