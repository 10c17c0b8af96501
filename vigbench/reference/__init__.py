"""The plain PyTorch reference of the benchmark's ViG configurations."""
