"""Entry points of the port: the batched serving loop (``serve``), the
training step (``steps``) and the fault-tolerant trainer (``train``)."""
