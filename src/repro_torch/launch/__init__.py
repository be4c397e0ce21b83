"""Command-line entry points of the PyTorch port."""
import os

# Where the AOT dry-run writes its per-cell JSON artifacts, which the fleet
# scheduler reads measured step costs back from (the JAX package's path).
DRYRUN_ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..",
    "benchmarks", "artifacts", "dryrun")
