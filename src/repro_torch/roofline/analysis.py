"""Three-term roofline of one step, from the dry run's per-device counts
(the port of ``repro.roofline.analysis``).

NVIDIA H100 SXM constants, a card, as the vendor publishes them:
  dense bfloat16 tensor-core peak   989 TFLOP/s
  float32 peak (no TF32)             67 TFLOP/s — the port's float32
                                     products run without TF32
  HBM3 bandwidth                   3.35 TB/s
  link bandwidth                     50 GB/s — one 400 Gb/s NDR port a
                                     card: a 16-wide mesh axis spans two
                                     hosts of 8 cards, so its collectives
                                     cross the network.  Within a host
                                     NVLink 4 moves 450 GB/s each way.

Terms (seconds a step):
  compute    = FLOPs / (chips × peak of the compute dtype)
  memory     = bytes / (chips × HBM bandwidth)
  collective = collective wire bytes a chip / link bandwidth

``flops`` and ``bytes`` are whole-mesh totals (the per-device count times
``chips``), as the reference's are.  MODEL_FLOPS = 6·N·D (dense) or
6·N_active·D (MoE) says how much of the counted compute is useful.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # FLOP/s a card
HBM_BW = 3.35e12  # B/s a card
LINK_BW = 50e9  # B/s a card, one NDR port (NVLink 4: 450e9 each way within a host)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes_per_chip: float
    model_flops: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_ratio: float
    peak_fraction: float  # MODEL_FLOPS / (chips × peak × t_dominant)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def analyze(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    hlo_flops: float,
    hlo_bytes: float,
    coll_bytes_per_chip: float,
    model_flops: float,
    dtype: str = "bfloat16",
) -> Roofline:
    """The roofline of a step whose counts are ``hlo_flops`` and
    ``hlo_bytes`` over the mesh and ``coll_bytes_per_chip`` a chip; its
    products run in ``dtype`` ("bfloat16" or "float32")."""
    peak = PEAK_FLOPS[dtype]
    t_c = hlo_flops / (chips * peak)
    t_m = hlo_bytes / (chips * HBM_BW)
    t_x = coll_bytes_per_chip / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    t_dom = max(terms.values())
    useful = model_flops / hlo_flops if hlo_flops else 0.0
    frac = model_flops / (chips * peak * t_dom) if t_dom > 0 else 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        coll_bytes_per_chip=coll_bytes_per_chip, model_flops=model_flops,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, useful_ratio=useful, peak_fraction=frac,
    )


def model_flops_estimate(cfg, shape, n_params: int, n_active: int) -> float:
    """6·N·D with D = processed tokens for this step shape.

    train: full fwd+bwd over B×S tokens  → 6·N·B·S
    prefill: forward only                → 2·N·B·S
    decode: forward for one new token    → 2·N·B·1
    """
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        k = 6.0
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        k = 2.0
    else:
        d = shape.global_batch
        k = 2.0
    n = n_active if n_active else n_params
    return k * n * d
