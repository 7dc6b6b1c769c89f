"""Optimizers (twin of ``repro.optim``): AdamW, dynamic loss scaling and
(hi, lo) bf16 master weights."""
