"""Share of a serving step in which no operation runs on the card, as the
step runs with the profiler off: 1 - the device's busy time a step in the
traced sub-window (the union of the trace's device intervals) over the
wall time a step in the rest of the window, in %."""
from port_bench.core.readers import idle_share_untraced


def read(rec):
    return idle_share_untraced(rec)
