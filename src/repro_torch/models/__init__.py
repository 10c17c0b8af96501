# Model definitions: the ViG backbones (models/vig.py) and their
# parameters (models/convert.py: spec, seeded init, JAX-tree conversion).
