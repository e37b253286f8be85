"""One-Class baseline: SimpleNet over a frozen encoder (counterpart of
idee_tpu/baselines/oneclass/)."""
