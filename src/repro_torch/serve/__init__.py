# Serving: the multi-tenant bucketed ViG image engine (serve/engine.py).
