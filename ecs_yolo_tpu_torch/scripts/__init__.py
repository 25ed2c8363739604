"""Kernel benches of the port, each the counterpart of a script under the
repository's ``scripts/``: run them as ``python -m
ecs_yolo_tpu_torch.scripts.<name>``."""
