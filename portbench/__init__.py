"""The benchmark of the PyTorch/CUDA port: ``python -m portbench.run``."""
