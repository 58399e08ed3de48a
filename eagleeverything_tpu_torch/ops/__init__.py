"""Device kernels: hand-written CUDA for Hopper over the packed stack, each
beside its plain PyTorch version."""
