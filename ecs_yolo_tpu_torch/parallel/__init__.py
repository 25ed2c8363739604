"""Process groups: multi-GPU and multi-host training (``multihost``) and the
``(data, model)`` layout with the state sharded over it (``mesh``)."""
