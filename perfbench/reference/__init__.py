"""The plain reference: the served model's forward in PyTorch, with no
kernel, cache or batching, and nothing of the program."""
