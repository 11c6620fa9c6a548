"""Data-parallel scale-out of the port on torch.distributed (sharding, launch)."""
