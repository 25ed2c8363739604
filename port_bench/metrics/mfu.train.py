"""The training micro-step's share of the card's bf16 peak over the traced
sub-window: three forwards' operations counted from the configuration's
shapes (counts/), over the sub-window's length, in %."""
from port_bench.core.readers import mfu


def read(rec):
    return mfu(rec)
