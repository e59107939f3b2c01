"""PyTorch/CUDA port of the LayerMerge reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``kernels``, ``models``, ``runtime``, ``compress``) and its
layouts (NHWC activations, HWIO weights), so plans, weights and ``.npz``
artifacts cross between the two unchanged.  It imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the card (``device="cuda"``) and
raise where there is none; ``device="cpu"`` runs the plain PyTorch versions
of the kernels.
"""
