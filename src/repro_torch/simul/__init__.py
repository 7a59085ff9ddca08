"""Reproduction of the paper's §V evaluation methodology (port of
``src/repro/simul``): the cycle and traffic simulator the tuner prices
plan configurations with, and the Table I datasets."""
from repro_torch.simul.datasets import TABLE_I, GraphData, dataset_names, load
from repro_torch.simul.machine import MachineConfig
from repro_torch.simul.memory import DramConfig
from repro_torch.simul.sim import SimResult, geomean, simulate

__all__ = [
    "TABLE_I",
    "GraphData",
    "dataset_names",
    "load",
    "MachineConfig",
    "DramConfig",
    "SimResult",
    "geomean",
    "simulate",
]
