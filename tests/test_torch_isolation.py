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
import repro_torch.core.scenarios, repro_torch.core.auction
import repro_torch.kernels.ops, repro_torch.kernels.build
import repro_torch.models, repro_torch.models.convert, repro_torch.configs
import repro_torch.serve.decode, repro_torch.launch.serve
import repro_torch.serve.market, repro_torch.serve.wal, repro_torch.serve.config
import repro_torch.checkpoint, repro_torch.checkpoint.store, repro_torch.checkpoint.service
import repro_torch.checkpoint.market, repro_torch.checkpoint.checkpoint
import repro_torch.models.attention, repro_torch.models.transformer, repro_torch.models.layers
import repro_torch.data.pipeline, repro_torch.launch.train
import repro_torch.train.optimizer, repro_torch.train.grad_compress, repro_torch.train.train_step
import repro_torch.configs.qwen3_1p7b, repro_torch.configs.minitron_8b
import repro_torch.configs.qwen2_72b, repro_torch.configs.qwen1p5_110b
import repro_torch.configs.deepseek_v3_671b, repro_torch.configs.kimi_k2_1t_a32b
import repro_torch.models.moe, repro_torch.models.mla, repro_torch.launch.supervisor
import importlib.util, pathlib
for path in sorted(pathlib.Path(sys.argv[1]).glob("*_torch.py")):  # the example twins
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    examples = SRC.parent / "examples"
    assert len(list(examples.glob("*_torch.py"))) == 5
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(examples)], env=env, capture_output=True, text=True,
        timeout=120, check=True,
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


def test_scenarios_and_sharded_settlement_without_a_gpu(monkeypatch):
    """Every scenario builder defaults to the card; a one-rank mesh needs no
    process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, builder in pt.SCENARIOS.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder()
        eco, sc = builder(device="cpu")
        assert eco.device.type == "cpu" and sc.name == name
    assert pt.users_mesh() == pt.UsersMesh(None, 1, 0)


def test_training_entry_points_without_a_gpu_raise(monkeypatch):
    import importlib.util

    from repro_torch.core.provisioner import DeviceGrant, grant_to_mesh
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grant_to_mesh(DeviceGrant("job", "c", 8))
    for name in ("quickstart", "market_sim", "market_service_demo", "serve_demo",
                 "elastic_train"):
        path = SRC.parent / "examples" / f"{name}_torch.py"
        spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])
