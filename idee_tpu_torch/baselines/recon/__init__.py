"""Reconstruction baselines: STEAL and UniAD (counterpart of
idee_tpu/baselines/recon/)."""
