"""Device mesh construction.

Axes:
  data   — data parallelism over utterance minibatches (gradient psum)
  seq    — sequence parallelism over the feature TIME axis.  Under GSPMD
           the conv/TDNN-F temporal shifts become automatic halo
           exchanges (collective-permute over ICI); the chain recursion
           stays sequential in T, so XLA re-gathers the output along
           'seq' before the loss.  Useful when per-chunk frame counts
           grow beyond what one chip's HBM holds for activations; at the
           production 150-frame chunks dp alone is faster.
  model  — tensor parallelism for the wide output/prefinal matmuls
           (3080 pdf-ids shard cleanly)

The mesh follows the algorithm alone: the cards of a host reach each other
all to all (NVLink), so the 'data' axis is a plain list of devices;
across hosts jax.distributed handles the process mesh, and 'seq' and
'model' stay intra-host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    seq: int = 1


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if config is None:
        config = MeshConfig(data=len(devices), model=1)
    n = config.data * config.seq * config.model
    if n > len(devices):
        raise ValueError(f"mesh {config} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.array(devices[:n]).reshape(config.data, config.seq,
                                         config.model)
    return Mesh(grid, axis_names=("data", "seq", "model"))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           heartbeat_timeout_seconds: Optional[int] = None,
                           ) -> None:
    """Multi-host bring-up: jax.distributed.initialize with explicit args or
    from the environment (JAX auto-detects cluster metadata such as SLURM
    when called with no args).  Safe to call once per process before any jax op;
    after it, jax.devices() spans all hosts and `make_mesh` builds the
    global mesh (dp within and across hosts).

    heartbeat_timeout_seconds: how quickly a dead peer process is
    detected and surfaced as an error to the survivors (default: jax's
    100s); lower it for fail-fast jobs under an external restarter."""
    import jax.distributed
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    if heartbeat_timeout_seconds is not None:
        kwargs["heartbeat_timeout_seconds"] = heartbeat_timeout_seconds
    jax.distributed.initialize(**kwargs)


def make_distributed_mesh(config: MeshConfig) -> Mesh:
    """Multi-host entry: call initialize_distributed() first (driver or
    launcher does this); jax.devices() then spans all hosts."""
    return make_mesh(config)
