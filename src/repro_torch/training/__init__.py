"""Training: data, AdamW, checkpoints and the train loops (the port of
``repro/training``)."""
