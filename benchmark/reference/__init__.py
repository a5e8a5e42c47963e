"""The plain reference: what a round's revealed vector has to be, in plain
PyTorch, NumPy and Python ints, from the inputs the benchmark made. It
imports nothing of the program."""
