"""Versioned, atomic, integrity-checked checkpoints (PyTorch port of
`repro.core.checkpoints`, same on-disk format).

Layout:  <dir>/step_<k>/
            manifest.json   {step, keys, shapes, dtypes, sha256, meta}
            <idx>.npy       one file per leaf (host numpy)

Writes are atomic (tmp dir + fsync + rename), restores verify content hashes,
and `latest_step` only ever returns complete checkpoints.  A tree is a
nested dict with tensor or array leaves; restore is template-based (the
caller supplies a tree with the same keys).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree: dict, prefix: str = "") -> list[tuple[str, object]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}[{k!r}]"
        out.extend(_flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save(directory: str, step: int, tree: dict, *, meta: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint for `step`; prune to the newest `keep`."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten(tree)
    host = [_to_host(x) for _, x in leaves]
    manifest = {
        "step": int(step),
        "keys": [k for k, _ in leaves],
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
        "sha256": [_sha256(a) for a in host],
        "meta": meta or {},
    }
    for i, a in enumerate(host):
        np.save(os.path.join(tmp, f"{i}.npy"), a)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic on POSIX

    steps = all_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str) -> list[int]:
    """Steps with a complete (manifest present) checkpoint."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


class IntegrityError(RuntimeError):
    pass


def restore_arrays(directory: str, step: int, *, verify: bool = True,
                   select=None) -> tuple[list[np.ndarray | None], dict]:
    """Load host arrays + manifest for `step`; verifies sha256 of every leaf
    read.  With `select` (key path -> bool) only the leaves it accepts are
    read; the others come back as None, their files untouched."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    arrays = []
    for i, (key, shape, dtype, digest) in enumerate(
            zip(manifest["keys"], manifest["shapes"], manifest["dtypes"],
                manifest["sha256"])):
        if select is not None and not select(key):
            arrays.append(None)
            continue
        a = np.load(os.path.join(path, f"{i}.npy"))
        if list(a.shape) != shape or str(a.dtype) != dtype:
            raise IntegrityError(f"leaf {i}: shape/dtype mismatch in {path}")
        if verify and _sha256(a) != digest:
            raise IntegrityError(f"leaf {i}: content hash mismatch in {path}")
        arrays.append(a)
    return arrays, manifest


def restore(directory: str, step: int, template: dict, *,
            verify: bool = True) -> tuple[dict, dict]:
    """Rebuild a tree with `template`'s keys from checkpoint `step`; leaves
    come back as CPU tensors."""
    arrays, manifest = restore_arrays(directory, step, verify=verify)
    keys = [k for k, _ in _flatten(template)]
    if keys != manifest["keys"]:
        raise IntegrityError(f"template keys {keys} != checkpoint keys "
                             f"{manifest['keys']}")
    flat = dict(zip(keys, (torch.from_numpy(a) for a in arrays)))

    def build(t: dict, prefix: str = "") -> dict:
        return {k: (build(v, f"{prefix}[{k!r}]") if isinstance(v, dict)
                    else flat[f"{prefix}[{k!r}]"]) for k, v in t.items()}

    return build(template), manifest
