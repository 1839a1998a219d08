"""Roofline terms of one rank's step on an NVIDIA H100, from a counter's
totals: the counterpart of ``repro/roofline/analysis.py``.

Hardware model, from NVIDIA's H100 Tensor Core GPU data sheet for the H100
SXM (80 GB): 989 TFLOP/s of dense bf16 on the tensor cores, 67 TFLOP/s of
fp32 outside them, 3.35 TB/s of HBM3, 80 GB of HBM; NVLink 4 at 900 GB/s
a GPU, 450 GB/s a direction, among the 8 GPUs of a node; between nodes
one ConnectX-7 of 400 Gb/s a GPU, 50 GB/s.  These are the card's
published peaks, not measured speeds: nothing here claims a measured
time.

Inputs are one rank's (``counter.Counter``: the rank's share of the mesh
traced on its own):

    compute_s    = flops / PEAK_FLOPS[compute dtype]
    memory_s     = traffic_bytes / PEAK_BYTES
    collective_s = sum over mesh axes of the axis's bytes / its link:
                   NVLINK_BW where the axis's group lies in one node of
                   8 GPUs, NETWORK_BW where it spans nodes

``repro``'s ``cost_flops_body_once`` / ``cost_bytes_body_once`` have no
counterpart: they were XLA's compiled cost analysis, which counts a loop
body once; an eager trace runs every layer, and there is no compiled
program to ask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --- H100 SXM 80 GB (NVIDIA data sheet) -------------------------------------
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # FLOP/s, dense
PEAK_BYTES = 3.35e12          # HBM3, B/s
HBM_BYTES = 80e9              # HBM a card
NVLINK_BW = 450e9             # NVLink 4, B/s a direction a GPU
NETWORK_BW = 50e9             # ConnectX-7 400 Gb/s a GPU, B/s
NODE_GPUS = 8


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float              # counted FLOPs of the rank
    traffic_bytes_per_device: float      # operand + result bytes a rank
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]   # bytes by kind
    collective_counts: Dict[str, int]
    collective_axes: Dict[str, float]        # bytes by mesh axis
    hbm_per_device: float                # counted peak of the rank
    model_flops: float                   # analytic global FLOPs per step
    compute_dtype: str
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap lower bound on step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): <1 flags remat and work
        the analytic model leaves out (attention's products); >1 flags
        what it counts that no matmul does (the embedding lookup)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_s / step_s: 1.0 = compute-bound at the card's peak."""
        return self.compute_s / self.step_s if self.step_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_s=self.step_s,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS per step: 6*N_active*D train / 2*N_active*D
    prefill / 2*N_active per generated token for decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def axis_bandwidth(intra_node: bool) -> float:
    """The link a collective over a mesh axis runs on."""
    return NVLINK_BW if intra_node else NETWORK_BW


def build_report(*, arch: str, shape, mesh_name: str, chips: int, counter,
                 cfg, compute_dtype: str = "bfloat16") -> RooflineReport:
    """The report of one rank's counted step (``counter.Counter``)."""
    flops = float(counter.flops)
    traffic = float(counter.traffic)
    by_axis = dict(counter.collective_axes)
    coll_s = sum(b / axis_bandwidth(counter.axis_intra_node.get(a, False))
                 for a, b in by_axis.items())
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops,
        traffic_bytes_per_device=traffic,
        collective_bytes_per_device=float(sum(by_axis.values())),
        collective_breakdown=dict(counter.collective_bytes),
        collective_counts=dict(counter.collective_counts),
        collective_axes=by_axis,
        hbm_per_device=float(counter.peak),
        model_flops=model_flops_for(cfg, shape),
        compute_dtype=compute_dtype,
        compute_s=flops / PEAK_FLOPS[compute_dtype],
        memory_s=traffic / PEAK_BYTES,
        collective_s=coll_s,
    )
