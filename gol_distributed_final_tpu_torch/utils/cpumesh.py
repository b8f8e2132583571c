"""Virtual CPU devices: how many mesh devices the port sees for
``device="cpu"``.

The JAX package validates its multi-device planes on one host by asking
XLA for ``n`` virtual CPU devices (``XLA_FLAGS=--xla_force_host_platform_
device_count=n``, its ``utils/cpumesh.py``). The port's mesh needs no
runtime's cooperation for that: several shards may sit on one
``torch.device``, so a virtual CPU device is just a slot of the mesh
(parallel/mesh.py). This module names how many slots ``device="cpu"``
offers, in an environment variable of the port's own, so a child process
(a rank of a multi-process job, a broker started by a test) inherits it.
"""

from __future__ import annotations

import os

#: the variable ``cpu_device_count`` reads; unset means one device
ENV = "GOL_TORCH_CPU_DEVICES"


def virtual_cpu_env(n_devices: int) -> dict:
    """Environment overrides for an ``n_devices``-wide virtual CPU mesh:
    merge them into a child process's environment."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return {ENV: str(int(n_devices))}


def force_virtual_cpu_devices(n_devices: int) -> bool:
    """Give THIS process ``n_devices`` virtual CPU devices (sets the
    variable). Always succeeds, unlike the JAX package's, whose backends
    may already be pinned: the port reads the count each time a mesh is
    built."""
    os.environ.update(virtual_cpu_env(n_devices))
    return True


def cpu_device_count() -> int:
    """The number of virtual CPU devices: ``GOL_TORCH_CPU_DEVICES``, or 1."""
    raw = os.environ.get(ENV, "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{ENV}={raw!r} is not a device count") from None
    if n < 1:
        raise ValueError(f"{ENV}={raw!r} must be >= 1")
    return n
