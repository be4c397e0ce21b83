"""Command-line entry points of the PyTorch port, and the process groups
and device meshes they run over (`mesh`)."""
import os

from .mesh import (init_distributed, make_fleet_mesh, make_host_mesh,
                   make_local_mesh)

# Where the dry run (`launch/dryrun.py`) writes its per-cell JSON
# artifacts, which the fleet scheduler reads measured step costs back from:
# `torch_artifacts/dryrun/` at the repo root (not committed).
DRYRUN_ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..",
    "torch_artifacts", "dryrun")

__all__ = ["DRYRUN_ARTIFACT_DIR", "init_distributed", "make_fleet_mesh",
           "make_host_mesh", "make_local_mesh"]
