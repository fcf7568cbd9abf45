"""Which collectives a 2-rank gloo world runs on CUDA tensors of one card.

NCCL refuses two ranks on one device, so a multi-rank run on a one-card
machine can only use gloo.  This probe tries every collective the sharded
train step uses: all-gather, reduce-scatter, all-reduce, broadcast,
point-to-point send/recv (the pipeline's ``batch_isend_irecv``), and
DTensor redistributions on a ``cuda`` DeviceMesh (Shard→Replicate,
Partial→Replicate, Partial→Shard).  Each runs in a world of its own (two
fresh ranks on ``cuda:0``, a FileStore rendezvous), since a gloo transport
error aborts the process.  Prints one JSON line: {collective: "ok" | the
error}.

    python3 tools/gloo_cuda_probe.py
"""
import json
import os
import subprocess
import sys
import tempfile

RANK = r"""
import json, sys
import torch, torch.distributed as dist
rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=2, rank=rank)
dev = torch.device("cuda", 0)
out = {}

def run(name, fn):
    try:
        fn()
        torch.cuda.synchronize()
        out[name] = "ok"
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    dist.barrier()  # a CPU-side barrier keeps the ranks in step after a failure

def all_gather():
    x = torch.full((4,), float(rank), device=dev)
    y = torch.empty(8, device=dev)
    dist.all_gather_into_tensor(y, x)
    assert y.tolist() == [0.0] * 4 + [1.0] * 4, y

def reduce_scatter():
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(y, x)
    assert y.tolist() == (2 * x[4 * rank:4 * rank + 4]).tolist(), y

def all_reduce():
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    assert x.tolist() == [3.0] * 4, x

def broadcast():
    x = torch.full((4,), float(rank), device=dev)
    dist.broadcast(x, 0)
    assert x.tolist() == [0.0] * 4, x

def send_recv():
    x = torch.full((4,), float(rank), device=dev)
    y = torch.empty(4, device=dev)
    ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, y, 1 - rank)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    assert y.tolist() == [float(1 - rank)] * 4, y

def dtensor():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = DeviceMesh("cuda", torch.arange(2))
    full = torch.arange(8, dtype=torch.float32, device=dev)
    s = DTensor.from_local(full[4 * rank:4 * rank + 4], mesh, [Shard(0)], run_check=False)
    assert s.redistribute(mesh, [Replicate()]).to_local().tolist() == full.tolist()
    p = DTensor.from_local(full.clone(), mesh, [Partial()], run_check=False)
    assert p.redistribute(mesh, [Replicate()]).to_local().tolist() == (2 * full).tolist()
    q = DTensor.from_local(full.clone(), mesh, [Partial()], run_check=False)
    got = q.redistribute(mesh, [Shard(0)]).to_local()
    assert got.tolist() == (2 * full[4 * rank:4 * rank + 4]).tolist(), got

name = sys.argv[3]
run(name, globals()[name])
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""
NAMES = ("all_gather", "reduce_scatter", "all_reduce", "broadcast", "send_recv", "dtensor")


def probe(name: str) -> str:
    """"ok", or what went wrong, for one collective in a fresh world."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), tmp, name],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    if all(p.returncode == 0 for p in procs):
        return json.loads(outs[0][0].strip().splitlines()[-1])[name]
    errs = [f"rank {r} exit {p.returncode}: " + (err.strip().splitlines() or ["-"])[-1][:200]
            for r, (p, (_, err)) in enumerate(zip(procs, outs)) if p.returncode]
    return "; ".join(errs)


def main() -> int:
    print(json.dumps({name: probe(name) for name in NAMES}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
