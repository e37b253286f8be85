# ------------------------------------------------------------------
"""Data parallelism over several GPUs (counterpart of
idee_tpu/parallel/): ``mesh.make_mesh`` under torchrun, the collectives
the losses, codebooks and steps take over the ``data`` axis."""
# ------------------------------------------------------------------
