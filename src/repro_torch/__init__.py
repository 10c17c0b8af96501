"""PyTorch/CUDA port of the DIGC + ViG serving path (``repro``'s layout).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX. Layout mirrors it: ``core/`` (DIGC spec, registry, reference
tier, graph ops), ``kernels/`` (the hand-written CUDA kernels, their
plain PyTorch versions and the ``cuda`` builder), ``models/`` (ViG) and
``serve/`` (the bucketed multi-tenant engine).

Kernel dispatch follows the tensors: a CUDA tensor launches the CUDA
kernel or raises, a CPU tensor takes the plain PyTorch version. Entry
points that create tensors take ``device="cuda"`` by default and raise
on a host without a card unless the caller passes ``device="cpu"``.
"""
