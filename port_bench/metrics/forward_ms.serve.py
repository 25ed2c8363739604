"""Device ms of one served forward (predict: the model and the head's
decode), CUDA events around it, the mean over the traced run's window."""
from port_bench.core.readers import mean_ms


def read(rec):
    return mean_ms(rec.get("forward_device_ms"))
