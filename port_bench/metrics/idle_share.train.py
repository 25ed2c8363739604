"""Share of the traced training sub-window in which no operation ran on the
card (the union of the trace's device intervals), in %."""
from port_bench.core.readers import idle_share


def read(rec):
    return idle_share(rec)
