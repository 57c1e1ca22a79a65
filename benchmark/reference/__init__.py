"""The plain reference that decides `correct`: plain PyTorch on the
scene's raw arrays, importing nothing of the program."""
