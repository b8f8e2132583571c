"""Faults planted in the broker's replies, to show that ``correct`` fails.

Only the benchmark's tests and its control runs (``benchmark/control.py``)
plant one; a benchmark run never does. Each wraps the broker's ``Run``
verb, where the board a reply carries is produced:

* ``unchanged``: a step that returns its state unchanged (the board sent,
  with the turns asked for);
* ``half``: every second request left out, answered with the board sent;
* ``flip``: one cell of every board a reply carries altered;
* ``control``: the plain reference in the program's place, with one
  guarantee the configuration states broken: the edges do not wrap;
* ``loads_jax``: a stub module named ``jax`` put in the broker's
  ``sys.modules`` by its first reply, as a lazy import in the program
  would; the run is then refused, not judged.
"""

from __future__ import annotations

import functools
import itertools
import sys
import types

import numpy as np

FAULTS = ("unchanged", "half", "flip", "control", "loads_jax")


def _answer(world, turns):
    from gol_distributed_final_tpu_torch.rpc.protocol import Response

    world = np.asarray(world, np.uint8)
    return Response(alive=[], alive_count=int(np.count_nonzero(world)),
                    turns_completed=int(turns), world=world)


def install(fault: str, service_cls) -> None:
    """Wrap ``service_cls.run``."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    calls = itertools.count()
    verb = service_cls.run

    @functools.wraps(verb)
    def faulty(self, req):
        if fault == "loads_jax":
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        if fault == "unchanged" or (fault == "half" and next(calls) % 2 == 0):
            return _answer(req.world, req.turns)
        if fault == "control":
            from benchmark import reference

            return _answer(reference.evolve(req.world, req.turns, wrap=False), req.turns)
        reply = verb(self, req)
        if fault == "flip":
            reply.world = np.array(reply.world, np.uint8)
            reply.world[0, 0] = 255 - reply.world[0, 0]
        return reply

    service_cls.run = faulty
