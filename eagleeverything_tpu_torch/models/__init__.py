"""Statistical models: the matrix-free engine, its backend over the packed
stack, and the dense NumPy oracle that anchors numerical correctness."""
