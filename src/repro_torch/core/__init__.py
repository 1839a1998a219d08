"""DPT core package.  Imports are lazy to avoid data<->core import cycles
(data.loader uses core.monitor; core.dpt uses data.loader)."""
import importlib

_EXPORTS = {
    "DPT": "repro_torch.core.dpt",
    "DPTConfig": "repro_torch.core.dpt",
    "DPTResult": "repro_torch.core.dpt",
    "FleetResult": "repro_torch.core.dpt",
    "MultiHostDPT": "repro_torch.core.dpt",
    "Trial": "repro_torch.core.dpt",
    "default_params": "repro_torch.core.dpt",
    "MemoryBudget": "repro_torch.core.monitor",
    "MemoryMonitor": "repro_torch.core.monitor",
    "MemoryOverflow": "repro_torch.core.monitor",
    "LoaderSimulator": "repro_torch.core.simulator",
    "MachineProfile": "repro_torch.core.simulator",
    "SimResult": "repro_torch.core.simulator",
    "LoaderEvaluator": "repro_torch.core.evaluators",
    "SimulatorEvaluator": "repro_torch.core.evaluators",
    "DPTCache": "repro_torch.core.cache",
    "search": "repro_torch.core",
}


def __getattr__(name):
    if name == "search":
        return importlib.import_module("repro_torch.core.search")
    if name in _EXPORTS:
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
