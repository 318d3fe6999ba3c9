"""Device mesh construction for multi-chip / multi-host runs.

The reference is single-process (SURVEY.md §2: TBB threads only); scale-out
here is new design surface per BASELINE.json: data-parallel reads ('dp'),
haplotype-parallel likelihood columns ('hp'), with XLA collectives (NCCL
on GPUs).  Hosts replicate the reference/index; read batches stream
through the dp axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_dp: int | None = None, n_hp: int = 1,
              devices=None) -> Mesh:
    """Build a ('dp', 'hp') mesh.  Defaults to all devices on the dp axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_hp
    if n_dp * n_hp != n:
        raise ValueError(f"mesh {n_dp}x{n_hp} != {n} devices")
    arr = np.asarray(devices).reshape(n_dp, n_hp)
    return Mesh(arr, ("dp", "hp"))
