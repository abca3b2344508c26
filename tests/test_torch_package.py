"""Package boundaries of the PyTorch port: paddle_tpu_torch, chip_smoke.py
and the kernel-variant scripts import neither ``jax`` nor anything of
``paddle_tpu`` (nor ``ml_dtypes``, which the card's machine lacks: bf16
crosses numpy as tagged ``uint16`` bits), and the entry points refuse to start without a card unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / n for n in ("chip_smoke.py", "flash_variants.py",
                                       "int8_rms_variants.py",
                                       "group_norm_routes.py")]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_paddle_tpu_imports():
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "paddle_tpu", "ml_dtypes"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_import_leaves_jax_out_and_chip_smoke_refuses_without_a_card():
    """In a fresh interpreter: importing the port pulls in no jax or
    paddle_tpu module, and (without a card) chip_smoke's main returns a
    non-zero code before printing any result."""
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving.engine\n"
            "import paddle_tpu_torch.models.llama, chip_smoke, torch\n"
            "import paddle_tpu_torch.models.unet\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.serving, paddle_tpu_torch.native\n"
            "import paddle_tpu_torch.serving.cluster.worker\n"
            "import paddle_tpu_torch.serving.cluster.frontend_proc\n"
            "import paddle_tpu_torch.serving.cluster.store_daemon\n"
            "import paddle_tpu_torch.distributed.rpc\n"
            "import paddle_tpu_torch.distributed.elastic\n"
            "import paddle_tpu_torch.inference.bundle\n"
            "import paddle_tpu_torch.inference.entries\n"
            "import paddle_tpu_torch.models.gpt, paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.nn.transformer\n"
            "import paddle_tpu_torch.incubate.nn.moe\n"
            "import paddle_tpu_torch.framework.random\n"
            "import paddle_tpu_torch.distributed.moe_utils\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu', 'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "if not torch.cuda.is_available():\n"
            "    assert chip_smoke.main() != 0\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert '"ok"' not in r.stdout


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.models.llama import TINY_CONFIG, LlamaForCausalLM
    from paddle_tpu_torch.models.unet import UNet2DConditionModel

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(TINY_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet2DConditionModel()
    model = LlamaForCausalLM(TINY_CONFIG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaDecoder(model)
    assert LlamaDecoder(model, device="cpu").device.type == "cpu"


def test_flags_env_override_and_set(monkeypatch):
    """A FLAGS_<name> variable sets a flag's first read, set_flags wins
    over it, and unknown names are refused, as in the JAX package."""
    from paddle_tpu_torch import flags as fl

    monkeypatch.setenv("FLAGS_use_decode_attention", "off")
    monkeypatch.setenv("FLAGS_decode_quant", "int8wk")
    f = fl._Flags()
    monkeypatch.setattr(fl, "flags", f)
    assert f.use_decode_attention is False and f.decode_quant == "int8wk"
    assert f.decode_fallback is False
    fl.set_flags({"use_decode_attention": "1", "decode_fallback": True})
    assert f.use_decode_attention is True and f.decode_fallback is True
    with pytest.raises(AttributeError):
        f.decode_attention_interpret
    with pytest.raises(KeyError):
        fl.set_flags({"decode_attention_interpret": True})
