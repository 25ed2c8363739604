"""Wall ms a batch spends after its forward ended on the card: NMS
(detect.frame_detections), the copies to the host, the rescale.  The step's
host time less the device time from the step's start to the forward's end
(CUDA events; the card is idle when a step starts), the mean over the traced
run's window."""
from port_bench.core.readers import mean_ms


def read(rec):
    return mean_ms(rec.get("after_forward_ms"))
