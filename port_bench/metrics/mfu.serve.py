"""The serving step's share of the card's bf16 peak: the forward's
operations counted from the configuration's shapes (counts/) over the
traced run's window less the profiled sub-window (host clock), in %."""
from port_bench.core.readers import mfu_untraced


def read(rec):
    return mfu_untraced(rec)
