"""The on-disk 2-bit genotype store (byte-identical to the JAX package's)."""
