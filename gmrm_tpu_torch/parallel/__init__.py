"""Marker-sharded training over ``torch.distributed`` (port of
gmrm_tpu/parallel)."""
