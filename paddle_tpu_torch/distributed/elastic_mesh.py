"""Elastic mesh: rebuild a training topology on whatever capacity survives
(port of ``paddle_tpu/distributed/elastic_mesh.py``).

A run can resume on a topology other than the one that wrote its
checkpoint — the missing half of "lose half the world, keep training":

- :func:`plan_mesh_shape` reshapes a saved mesh onto a different rank
  count. Axes whose size is SEMANTIC (``mp``/``sp``/``ep``/``pp`` —
  resizing them would change the partitioned program, not just the data
  distribution) are frozen; the data-parallel axes (``dp``/``sdp``)
  absorb the shrink or grow.
- :func:`reshaped_mesh` builds and installs that mesh for the current
  incarnation, reading the saved topology from the newest checkpoint's
  ``metadata.json`` (``checkpoint.mesh_info``). Checkpoints without mesh
  metadata fall back to caller-supplied axes — the same-topology path.
- :func:`rescale_batch` keeps the GLOBAL batch constant across a resize
  and returns the new per-replica slice, so the loss trajectory, the
  optimizer schedule and the data cursor all stay valid.

Restore itself is topology-agnostic: ``checkpoint.load_state(shardings=
...)`` reads, for each leaf, only the slice a rank's new layout needs,
with bounded host memory, so a shrunk or regrown worker builds its mesh
through :func:`reshaped_mesh` before it builds the train step, then
restores. In the port a mesh's "devices" are the world's ranks (one card
each); ``devices`` takes a count or a sequence whose length is used.

Reference parity: the reference's elastic manager
(``fleet/elastic/manager.py``) resizes the WORLD and re-slices state
through ``fleet.save/load``.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

from . import checkpoint as _ckpt
from .mesh import init_mesh

__all__ = [
    "FROZEN_AXES", "plan_mesh_shape", "reshaped_mesh", "rescale_batch",
    "is_elastic",
]

# axes that partition the PROGRAM (tensor/sequence/expert/pipeline
# parallel): a resize must preserve them — shrinking "mp" would change
# every layer's shard shapes and the math itself, not just how many data
# replicas run. Only the data axes scale.
FROZEN_AXES = ("mp", "sp", "ep", "pp")
_PRIMARY_DATA_AXES = ("dp", "sdp")


def plan_mesh_shape(saved_axes: Dict[str, int], n_devices: int,
                    frozen: Sequence[str] = FROZEN_AXES) -> Dict[str, int]:
    """Reshape ``saved_axes`` (a ``{axis: size}`` mesh shape) onto
    ``n_devices`` devices.

    Frozen axes keep their exact size — ``n_devices`` must be divisible by
    their product, otherwise the surviving capacity cannot host the
    partitioned program and a :class:`ValueError` says so. The remaining
    (data) axes are rescaled to absorb the change: the primary data axis
    (``dp``, else ``sdp``, else the first non-frozen axis) takes whatever
    the others leave, and every other data axis is shrunk to
    ``gcd(old_size, remaining)`` so the product always lands exactly on
    ``n_devices`` — a deterministic plan both the shrink and the re-grow
    side compute identically.

    >>> plan_mesh_shape({"dp": 4, "mp": 2}, 4)
    {'dp': 2, 'mp': 2}
    >>> plan_mesh_shape({"dp": 2, "sdp": 2, "mp": 2}, 4)
    {'dp': 1, 'sdp': 2, 'mp': 2}
    """
    if n_devices < 1:
        raise ValueError(f"cannot build a mesh on {n_devices} devices")
    saved = {str(k): int(v) for k, v in dict(saved_axes).items()}
    out: Dict[str, int] = dict(saved)
    frozen_present = {k: v for k, v in saved.items() if k in frozen}
    frozen_prod = int(np.prod(list(frozen_present.values()))) \
        if frozen_present else 1
    if n_devices % frozen_prod != 0:
        raise ValueError(
            f"elastic resize impossible: frozen axes {frozen_present} need "
            f"a multiple of {frozen_prod} devices, got {n_devices} — the "
            f"surviving capacity cannot host the model-parallel layout "
            f"(restore onto >= {frozen_prod} devices, or retrain with a "
            f"smaller mp/pp degree)")
    remaining = n_devices // frozen_prod
    data_axes = [k for k in saved if k not in frozen_present]
    primary = next((a for a in _PRIMARY_DATA_AXES if a in data_axes),
                   data_axes[0] if data_axes else None)
    for k in data_axes:
        if k == primary:
            continue
        out[k] = math.gcd(saved[k], remaining)
        remaining //= out[k]
    if primary is not None:
        out[primary] = remaining
    elif remaining > 1:
        # a fully model-parallel mesh grown onto more devices: the extra
        # capacity becomes data parallelism
        out = {"dp": remaining, **out}
    return out


def _resolve_checkpoint_dir(path: Optional[str]) -> Optional[str]:
    """Accept either a concrete ``step_N`` checkpoint directory or an
    AutoCheckpoint root; returns the directory whose metadata to read."""
    if path is None:
        return None
    if os.path.exists(os.path.join(path, _ckpt._METADATA)):
        return path
    # cheap pick (verify=False): only the mesh RECORD is read here; the
    # actual restore re-validates through latest_checkpoint(verify=True)
    return _ckpt.latest_checkpoint(path, verify=False)


def reshaped_mesh(checkpoint_dir: Optional[str] = None,
                  default_axes: Optional[Dict[str, int]] = None,
                  devices=None,
                  frozen: Sequence[str] = FROZEN_AXES):
    """Build AND install (``init_mesh``) the mesh for this incarnation:
    the topology recorded in ``checkpoint_dir`` (a ``step_N`` dir or an
    AutoCheckpoint root), reshaped via :func:`plan_mesh_shape` onto the
    live rank count (``devices``: a count or a sequence, default the
    world's size). Every rank of the world calls it (``init_mesh`` makes
    the axes' groups collectively).

    ``default_axes`` is the fresh-start/old-checkpoint fallback (no
    checkpoint yet, or one written before mesh metadata existed): its
    shape is planned onto the live devices the same way, so a worker can
    unconditionally call ``reshaped_mesh(root, default_axes={"dp": -1,
    "mp": 2})`` at startup — first launch, resume, shrink, and re-grow all
    take the same line. ``-1`` in ``default_axes`` means "the rest", as in
    ``init_mesh``.
    """
    from . import env

    if devices is None:
        n = env.get_world_size()
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(devices)
    info = _ckpt.mesh_info(_resolve_checkpoint_dir(checkpoint_dir)) \
        if checkpoint_dir is not None else None
    if info is not None and info.get("axes"):
        shape = plan_mesh_shape(info["axes"], n, frozen)
    else:
        shape = dict(default_axes or {"dp": n})
        if -1 in shape.values():
            known = int(np.prod([s for s in shape.values() if s != -1]))
            shape = {k: (n // known if v == -1 else v)
                     for k, v in shape.items()}
        shape = plan_mesh_shape(shape, n, frozen)
    return init_mesh(shape, devices=range(n))


def rescale_batch(global_batch: int, axes: Dict[str, int],
                  frozen: Sequence[str] = FROZEN_AXES) -> int:
    """Per-replica batch after an elastic resize.

    The GLOBAL batch stays constant across shrink/grow — that is what
    keeps the loss trajectory, the LR schedule, and the data cursor's
    batch accounting valid — so each data replica (the product of every
    non-frozen mesh axis) takes a larger or smaller slice. Raises :class:`ValueError` when the global
    batch does not divide the new replica count (the caller must then pad
    the batch or pick a compatible capacity; silently changing the global
    batch would corrupt the resumed trajectory).
    """
    # every non-frozen axis is a data axis (the same definition
    # plan_mesh_shape scales by), not just the canonical dp/sdp names —
    # a caller that planned with a custom `frozen` set must pass the
    # same set here or the replica count disagrees with the plan
    data = {a: int(s) for a, s in dict(axes).items() if a not in frozen}
    replicas = int(np.prod(list(data.values()))) if data else 1
    if global_batch % max(1, replicas) != 0:
        raise ValueError(
            f"global batch {global_batch} does not divide across "
            f"{replicas} data replicas ({data}); keep the global batch "
            f"divisible by every world size the job may shrink to, or "
            f"rescale the cursor with DataCursor.rescale")
    return global_batch // max(1, replicas)


def is_elastic() -> bool:
    """True when this worker was started by ``distributed.launch`` in
    elastic mode (``--nnodes min:max``) — the hint that meshes should be
    built through :func:`reshaped_mesh` rather than a fixed shape."""
    return os.environ.get("PADDLE_ELASTIC", "") == "1"
