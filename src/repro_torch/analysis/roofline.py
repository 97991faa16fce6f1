"""Three-term roofline from the dry run's per-device counts (port of
``repro.analysis.roofline``, on the H100's constants).

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = dot-operand bytes per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

The counts come from ``launch.dryrun``, which runs the step once on a
fake process group and counts each per-device (local) operation: FLOPs
of every matrix product (2 * numel(out) * K), the bytes of every matrix
product's operands and result (the reference's ``dot_bytes``), and the
per-device result buffer of every collective.  The reference reads the
same three quantities out of XLA's optimized HLO (``parse_hlo_costs``);
torch makes no HLO, so the port counts the operations as they run.

Hardware constants: one H100 SXM5 — 989e12 dense bf16 FLOP/s, 3.35e12
HBM bytes/s.  Collectives: 50e9 bytes/s per GPU, the InfiniBand NDR
link (400 Gb/s per GPU) between nodes.  A node holds 8 GPUs, so a
16-wide `model` axis (and every `data` / `pod` group) spans at least two
nodes and each ring runs at the rate of its slowest hop, InfiniBand's —
not NVLink's 450 GB/s per direction, which only a group inside one node
would see.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# --- H100 SXM5 constants ---------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 dense per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s per GPU, InfiniBand NDR between nodes


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device numbers
    flops: float
    bytes_hbm: float
    bytes_collective: float
    raw_cost_flops: float       # torch.utils.flop_counter's count
    raw_cost_bytes: float       # every local op's operands + results
    mem_argument_bytes: float
    mem_temp_bytes: float
    mem_output_bytes: float
    model_flops: float          # 6*N*D (analytic, global)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self):
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.bytes_hbm / HBM_BW
        self.collective_s = self.bytes_collective / LINK_BW
        return self

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bottleneck"] = self.bottleneck
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d
