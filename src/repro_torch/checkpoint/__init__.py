"""Step-atomic checkpoints of the trainer's params, optimizer state and
data cursor."""
