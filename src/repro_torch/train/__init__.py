"""Training: the step builder, checkpoints (held against ``repro/train``)."""
