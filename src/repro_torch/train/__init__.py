"""Training: the loss and step builders, AdamW with float32 master
weights, and the trainer with checkpoints and a straggler watchdog."""
