"""Per-rank parameter bytes of an arch on a mesh, by arithmetic: the shapes of
``models.params.abstract_params`` divided as ``validated_pspec_tree`` lays
them out (no weights are made, no rank is needed).

    PYTHONPATH=src python tools/shard_bytes.py --arch kimi-k2-1t-a32b --mesh 16x16

Prints one JSON line: the parameter count, the whole tree's bytes in bf16,
and per rank the largest and the mean share in bf16 and for float32 training
(weights, gradients and AdamW's two moments: 16 bytes a parameter), and the
parameters that stay replicated.
"""
import argparse
import json
import math

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import get_api
from repro_torch.models.params import (abstract_params, count_params, tree_leaves, tree_map,
                                       validated_pspec_tree)
from repro_torch.sharding.specs import axis_sizes


def per_rank(arch: str, shape: tuple[int, ...], names: tuple[str, ...]) -> dict:
    cfg = get_config(arch)
    decls = get_api(cfg).decls(cfg)
    mesh = AbstractMesh(names, shape)
    sizes = axis_sizes(mesh)
    specs = validated_pspec_tree(decls, mesh)
    shares = []  # (elements on one rank, elements whole)

    def leaf(t, spec):
        split = math.prod(sizes[n] for e in spec if e is not None
                          for n in (e if isinstance(e, tuple) else (e,)))
        shares.append((t.numel() // split, t.numel()))

    tree_map(leaf, abstract_params(decls), specs)
    on_rank = sum(a for a, _ in shares)
    replicated = sum(whole for a, whole in shares if a == whole)
    n = count_params(decls)
    ranks = math.prod(shape)
    return {"arch": arch, "mesh": "x".join(map(str, shape)), "params": n,
            "leaves": len(tree_leaves(abstract_params(decls))),
            "bf16_gb_whole": n * 2 / 1e9, "bf16_gb_per_rank": on_rank * 2 / 1e9,
            "fp32_train_gb_per_rank": on_rank * 16 / 1e9,
            "even_split_gb_per_rank_bf16": n * 2 / ranks / 1e9,
            "replicated_params": replicated}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--mesh", default="16x16", help="DxM or PxDxM")
    args = ap.parse_args()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    print(json.dumps(per_rank(args.arch, shape, names)))


if __name__ == "__main__":
    main()
