# ------------------------------------------------------------------
"""Data and spatial parallelism over several GPUs (counterpart of
idee_tpu/parallel/): ``mesh.make_mesh`` under torchrun, the collectives
the losses, codebooks and steps take over the mesh, and ``spatial``'s
halo and shifted-window exchanges over the ``space`` axis."""
# ------------------------------------------------------------------
