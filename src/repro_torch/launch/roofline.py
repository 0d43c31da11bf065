"""Roofline-term extraction from compiled dry-run artifacts.

  compute term    = FLOPs / (chips * peak_FLOP/s)
  memory term     = HBM bytes / (chips * HBM_bw)
  collective term = collective bytes per chip / link_bw

Sources:
  * ``compiled.cost_analysis()`` provides per-device HLO flops/bytes — BUT
    XLA counts ``while``/``scan`` bodies ONCE, not x trip count (verified by
    calibration: a 10-iteration scanned matmul reports exactly 1/10 the
    unrolled flops). Our models scan over layer periods, so raw values
    undercount. The roofline terms therefore use the analytic per-step cost
    model (launch.analytic — validated against an unrolled tiny compile);
    raw cost_analysis values are recorded alongside.
  * Collective bytes are parsed from the post-SPMD HLO text
    (``compiled.as_text()``, shapes already per-device): the output-shape
    bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
    collective-permute, with instructions inside while bodies multiplied by
    the layer-scan trip count (they appear once in the text but execute
    every iteration). all-reduce is counted twice (RS+AG equivalence).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.analytic import scan_trip_multiplier, step_cost
from repro_torch.utils.hw import ChipSpec

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo_text: str,
                              loop_multiplier: int = 1) -> Dict[str, int]:
    """Per-collective-kind per-device bytes. Instructions inside while-loop
    body computations are scaled by ``loop_multiplier``."""
    # find computation names used as while bodies
    body_names = set(re.findall(r"body=%?([\w.\-]+)", hlo_text))
    out = {k: 0 for k in _COLLECTIVES}
    current_comp = None
    for line in hlo_text.splitlines():
        s = line.strip()
        mdef = re.match(r"%?([\w.\-]+)\s*(?:\([^)]*\))?\s*->.*{\s*$", s)
        if ("{" in s and "=" not in s.split("{")[0] and
                (s.startswith("%") or s.startswith("ENTRY")
                 or mdef is not None)):
            m2 = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)", s)
            if m2:
                current_comp = m2.group(1)
            continue
        m = re.match(r"%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+([\w\-]+)", s)
        if not m:
            continue
        shape_str, op = m.groups()
        op = op.rstrip("(")
        for kind in _COLLECTIVES:
            if op == kind or op.startswith(kind + "-start"):
                mult = loop_multiplier if current_comp in body_names else 1
                out[kind] += _shape_bytes(shape_str) * mult
                break
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # analytic (scan-corrected) accounting used for the terms
    flops_global: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: Dict[str, int]
    compute_term_s: float
    memory_term_s: float
    collective_term_s: float
    model_flops: float
    useful_flops_ratio: float
    # raw compiled cost_analysis (per-iteration semantics, see module doc)
    hlo_flops_raw_per_chip: float
    hlo_bytes_raw_per_chip: float
    scan_multiplier: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term_s,
                 "memory": self.memory_term_s,
                 "collective": self.collective_term_s}
        return max(terms, key=terms.get)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        return d


def analyze(arch: str, shape_name: str, mesh_name: str, *, compiled,
            cfg: ModelConfig, shape: InputShape, chip: ChipSpec,
            n_chips: int, tokens_processed: int,
            window_override="cfg", model_shards: int = 16,
            data_shards: int = 16, fsdp: bool = True,
            batch_shards: int = 1) -> RooflineReport:
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    raw_flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))

    mult = scan_trip_multiplier(cfg)
    coll = collective_bytes_from_hlo(compiled.as_text(),
                                     loop_multiplier=mult)
    coll_bytes = sum(v * (2 if k == "all-reduce" else 1)
                     for k, v in coll.items())

    ac = step_cost(cfg, shape, window_override, n_chips=n_chips,
                   model_shards=model_shards, data_shards=data_shards,
                   fsdp=fsdp, batch_shards=batch_shards)
    flops_per_chip = ac.flops_global / n_chips
    bytes_per_chip = ac.hbm_bytes_per_chip

    compute_term = flops_per_chip / chip.peak_flops_bf16
    memory_term = bytes_per_chip / chip.hbm_bandwidth
    collective_term = coll_bytes / chip.ici_link_bandwidth

    factor = 6.0 if shape.mode == "train" else 2.0
    model_flops = factor * cfg.active_params_per_token() * tokens_processed
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
        flops_global=ac.flops_global,
        hbm_bytes_per_chip=bytes_per_chip,
        collective_bytes_per_chip=coll_bytes, collectives=coll,
        compute_term_s=compute_term, memory_term_s=memory_term,
        collective_term_s=collective_term, model_flops=model_flops,
        useful_flops_ratio=model_flops / max(1.0, ac.flops_global),
        hlo_flops_raw_per_chip=raw_flops,
        hlo_bytes_raw_per_chip=raw_bytes,
        scan_multiplier=mult)
