"""SPMD planning over ``torch.distributed``: process meshes, puzzle-sharded
groups, the frontier-sharded search of one puzzle, and multi-process
benchmark planning."""
