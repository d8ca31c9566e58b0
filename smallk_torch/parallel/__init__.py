"""The sharded solve on torch.distributed: a terms x docs mesh of ranks
(mesh.py) and the process group it runs on (distributed.py)."""
