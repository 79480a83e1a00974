"""Multi-GPU execution: POI batches over a mesh (``mesh``) and z-sharded
DVC with halo exchange (``halo``), on ``torch.distributed``."""
