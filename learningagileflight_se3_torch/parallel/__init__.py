"""Data-parallel training over processes: the scenario mesh (mesh.py), the
process-group set-up (distributed.py) and the sharded dry run (dryrun.py)."""
