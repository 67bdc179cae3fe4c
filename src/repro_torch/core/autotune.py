"""Algorithm selection from the postal model — paper §4 as a rule.

Transcribed from ``src/repro/core/autotune.py``: given (p, p_local, message
bytes, machine), evaluate the modeled cost of every allgather algorithm and
return the cheapest. The port has no tuning table and no H100 parameter set
yet (``cost_model`` carries the JAX package's machines as parity data), so
the machine is always named by the caller and nothing here chooses the
port's schedules: ``collectives`` raises for ``algorithm="auto"``.
"""
from __future__ import annotations

from .cost_model import MACHINES, MODELS, MachineParams


def pick_allgather(p: int, p_local: int, nbytes_per_rank: float,
                   machine: MachineParams | str) -> str:
    if isinstance(machine, str):
        machine = MACHINES[machine]
    if p_local <= 1 or p <= p_local:
        return "bruck"
    block = nbytes_per_rank
    costs = {name: fn(p, p_local, block, machine)
             for name, fn in MODELS.items()}
    return min(costs, key=costs.get)


def model_costs(p: int, p_local: int, nbytes_per_rank: float,
                machine: MachineParams | str) -> dict[str, float]:
    if isinstance(machine, str):
        machine = MACHINES[machine]
    return {name: fn(p, p_local, nbytes_per_rank, machine)
            for name, fn in MODELS.items()}
