"""Run-level utilities: checkpoints (``checkpoint``)."""
