"""Training: optimizers, the train step, checkpoints and the fault-tolerant
loop (``repro.train``), single device."""
