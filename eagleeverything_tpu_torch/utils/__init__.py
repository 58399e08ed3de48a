"""Runtime utilities: config, device choice, logging, checkpointing."""
