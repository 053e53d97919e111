"""The benchmark's plain reference: what ``correct`` compares the port's
timed path with. Plain PyTorch and NumPy, computed again from the
benchmark's own inputs (images, labels, weights, draws); it imports
neither JAX, the JAX package, nor anything of the port."""
