"""The port stands alone: it imports neither JAX nor the JAX package, and it
never moves to the CPU on its own when a GPU was asked for."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as pt  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import json, sys
import repro_torch, repro_torch.core, repro_torch.core.provisioner, repro_torch.core.fused
import repro_torch.kernels.ops, repro_torch.kernels.build
import repro_torch.models, repro_torch.models.convert, repro_torch.configs
import repro_torch.serve.decode, repro_torch.launch.serve
import repro_torch.serve.market, repro_torch.serve.wal, repro_torch.serve.config
import repro_torch.checkpoint, repro_torch.checkpoint.store, repro_torch.checkpoint.service
import repro_torch.checkpoint.market
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True, timeout=120,
        check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.as_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_fleet_economy(seed=0)  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.random_market(10, 4)
    assert pt.make_fleet_economy(seed=0, device="cpu").device.type == "cpu"


def test_model_entry_points_without_a_gpu_raise(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("rwkv6-7b")
    api = get_api(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator(), api.decls(cfg))  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-7b", "--smoke"])
    params = init_params(torch.Generator(), api.decls(cfg), device="cpu")
    assert params["embed"].device.type == "cpu"


def test_service_entry_points_without_a_gpu_raise(monkeypatch):
    import numpy as np

    from repro_torch.serve.market import BidDelta, MarketService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MarketService(base, num_bundles=2, k_bound=2)  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.MarketBook(base, 2, 2)
    eco = pt.make_fleet_economy(seed=0, device="cpu")
    assert MarketService.from_economy(eco).device.type == "cpu"  # the economy's device
    svc = MarketService(base, num_bundles=2, k_bound=2, device="cpu")
    assert svc.submit(BidDelta("a", [([0, 1], [1.0, 2.0])], [5.0]))
    assert svc.tick().bids_submitted == 1 and "a" in svc.book
    assert svc.book.device.type == "cpu"
    assert pt.MarketBook(base, 2, 2, device="cpu").device.type == "cpu"
