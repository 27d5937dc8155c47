"""The plain reference of both configurations: float32 PyTorch, nothing of the program."""
