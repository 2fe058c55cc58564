"""Data- and tensor-parallel episodes on torch.distributed (mesh.py)."""
