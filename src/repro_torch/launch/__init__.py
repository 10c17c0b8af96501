# Drivers: the model API bundle (api.py) and the LM serving CLI (serve.py).
