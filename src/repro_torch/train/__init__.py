"""Training: AdamW, the train step and checkpoints (port of
``repro.train``)."""
