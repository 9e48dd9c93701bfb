"""Training: optimizer, state, steps, eval pipeline and the OfficeHome loop."""
