"""The benchmark of ``ecs_yolo_tpu_torch`` on one NVIDIA H100 (see ``run.py``)."""
