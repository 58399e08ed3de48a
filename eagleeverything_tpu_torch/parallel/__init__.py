"""Multi-device parallelism over ``torch.distributed``: the (ind, snp) mesh
over the ranks, the psum-merged MMt, the SNP-sharded score sweep and its
collective argmax (the JAX package's parallel/, one process per card)."""
