# ------------------------------------------------------------------
"""The baseline zoo on PyTorch (counterpart of idee_tpu/baselines/):
MIL (DeepMIL, ARNet, RTFM, MGFN), One-Class (SimpleNet) and
Reconstruction (STEAL, UniAD) heads over the port's shared encoders,
dataset, metrics and checkpoints.

Bags: every model scores all pixels densely and the MIL losses take bag
membership as a mask (masked top-k), as in the JAX package; where a bag
holds fewer than k instances the invalid top-k slots leave the mean.
Top-k breaks ties by the lower index, as ``jax.lax.top_k`` does (a
stable sort), so the losses that gather by those indices pick the same
instances on the CPU and on the card.

Randomness the JAX package draws from its PRNG keys (instance drop,
SimpleNet's noise, UniAD's jitter, every dropout and drop path) is drawn
here from an explicit ``torch.Generator``. At cfg.dtype "bfloat16" the
MIL models and SimpleNet's frozen backbone compute in bf16, as JAX builds
them at cfg.dtype (its parameters float32); MGFN's head, SimpleNet's head,
STEAL and UniAD, which JAX builds without a dtype, compute in float32.
The baselines' drivers run on one device (JAX's have no mesh).
"""
# ------------------------------------------------------------------
