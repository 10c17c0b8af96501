"""Twins of the JAX package's ``examples/`` scripts: each module has a
``main(argv=None)``, runs as ``python -m repro_torch.examples.<name>``, on
the card by default and on the CPU with ``--device cpu``."""
