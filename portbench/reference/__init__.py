"""Plain float32 PyTorch references: no import of the port, no kernel."""
