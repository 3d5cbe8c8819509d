"""Plain float32 PyTorch references, one a configuration, which import
nothing of the program under test."""
