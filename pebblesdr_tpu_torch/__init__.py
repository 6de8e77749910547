"""PyTorch/CUDA port of pebblesdr_tpu.

The layout mirrors the JAX package (core/ ops/ demod/ chain/ utils/) so each
module's counterpart is easy to find; the JAX package stays the numerical
reference.  This package imports torch, numpy and scipy and never jax.

Device choice is explicit: every factory that allocates takes a ``device``
argument, and ``chain.receiver.Receiver(cfg, device=...)`` runs its whole
graph there.  On a CUDA device the fused front end launches the hand-written
CUDA kernel in ``csrc/front.cu`` (built with nvcc at first use into
``build/kernels/``); on the CPU it runs the kernel's plain PyTorch version.
"""
