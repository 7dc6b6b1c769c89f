"""Optimizers (twin of ``repro.optim``): AdamW so far."""
