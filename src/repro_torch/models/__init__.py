# Model definitions: the ViG backbones (models/vig.py), the decoder LM
# (models/{config,layers,transformer}.py, module.py's param specs) and
# parameter conversion from the JAX package's trees (models/convert.py).
