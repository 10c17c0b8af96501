# Serving: the LM slot engine (ServeEngine) and the multi-tenant bucketed
# ViG image engine on the (B, N) lattice (serve/engine.py), and the
# admission scheduler's clock and traces (serve/sched.py).
