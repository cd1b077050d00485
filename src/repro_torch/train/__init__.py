"""Training: the loss and step builders (the EF-int8 compressed step over
a ``"pod"`` mesh too), AdamW with float32 master weights, the gradient
compression, and the trainer with checkpoints and a straggler watchdog."""
