"""The PyTorch port stands alone: it imports neither JAX, flax nor the JAX
package, and its entry points refuse to run on the host unless asked."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pytorch_distributed_training_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "pytorch_distributed_training_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {
        str(f.relative_to(REPO)): sorted(_imported_roots(f) & set(FORBIDDEN))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


def test_port_imports_with_jax_blocked():
    """Import the serving and training entry points, the ResNet path's,
    the data-parallel path's (the two-tier sync's slice split, striping
    and sync among them), the sharded paths' (the mesh, the placement
    rules and layout, ring attention and Ulysses), the pipeline's (the
    schedule tables, the engines and the pipelined GPT-2), the ViT path's,
    the MoE layers, the checkpoint and
    resilience modules (the skip gate and recovery among them) and the
    device caches in a fresh
    interpreter where importing jax, flax or the JAX package fails."""
    blocked = ", ".join(repr(m) for m in FORBIDDEN)
    code = (
        "import sys\n"
        f"for m in ({blocked},):\n"
        "    sys.modules[m] = None\n"
        "import pytorch_distributed_training_tpu_torch.cli.main\n"
        "import pytorch_distributed_training_tpu_torch.serve.engine\n"
        "import pytorch_distributed_training_tpu_torch.models.generate\n"
        "import pytorch_distributed_training_tpu_torch.serve.kv_pool\n"
        "import pytorch_distributed_training_tpu_torch.serve.kv_store\n"
        "import pytorch_distributed_training_tpu_torch.ops.paged_attention\n"
        "import pytorch_distributed_training_tpu_torch.ops.flash_attention\n"
        "import pytorch_distributed_training_tpu_torch.ops.losses\n"
        "import pytorch_distributed_training_tpu_torch.train.step\n"
        "import pytorch_distributed_training_tpu_torch.train.state\n"
        "import pytorch_distributed_training_tpu_torch.train.trainer\n"
        "import pytorch_distributed_training_tpu_torch.parallel.grad_accum\n"
        "import pytorch_distributed_training_tpu_torch.data.loader\n"
        "import pytorch_distributed_training_tpu_torch.data.datasets\n"
        "import pytorch_distributed_training_tpu_torch.tools.train_profile\n"
        "import pytorch_distributed_training_tpu_torch.ops.fused_norm\n"
        "import pytorch_distributed_training_tpu_torch.ops.s2d_stem\n"
        "import pytorch_distributed_training_tpu_torch.models.resnet\n"
        "import pytorch_distributed_training_tpu_torch.models.convert\n"
        "import pytorch_distributed_training_tpu_torch.models.registry\n"
        "import pytorch_distributed_training_tpu_torch.models.moe\n"
        "import pytorch_distributed_training_tpu_torch.data.transforms\n"
        "import pytorch_distributed_training_tpu_torch.data.native\n"
        "import pytorch_distributed_training_tpu_torch.data.lm_corpus\n"
        "import pytorch_distributed_training_tpu_torch.comm.init\n"
        "import pytorch_distributed_training_tpu_torch.comm.collectives\n"
        "import pytorch_distributed_training_tpu_torch.comm.mesh\n"
        "import pytorch_distributed_training_tpu_torch.comm.striping\n"
        "import pytorch_distributed_training_tpu_torch.comm.hierarchical\n"
        "import pytorch_distributed_training_tpu_torch.parallel.sharding\n"
        "import pytorch_distributed_training_tpu_torch.parallel.sharded\n"
        "import pytorch_distributed_training_tpu_torch.parallel."
        "ring_attention\n"
        "import pytorch_distributed_training_tpu_torch.parallel.ulysses\n"
        "import pytorch_distributed_training_tpu_torch.parallel."
        "pipeline_schedule\n"
        "import pytorch_distributed_training_tpu_torch.parallel.pipeline\n"
        "import pytorch_distributed_training_tpu_torch.parallel."
        "gpt2_pipeline\n"
        "import pytorch_distributed_training_tpu_torch.utils.seeding\n"
        "import pytorch_distributed_training_tpu_torch.tools.dp_check\n"
        "import pytorch_distributed_training_tpu_torch.models.vit\n"
        "import pytorch_distributed_training_tpu_torch.data.imagenet\n"
        "import pytorch_distributed_training_tpu_torch.ops.pooling\n"
        "import pytorch_distributed_training_tpu_torch.checkpoint.manager\n"
        "import pytorch_distributed_training_tpu_torch.resilience.faults\n"
        "import pytorch_distributed_training_tpu_torch.resilience."
        "preemption\n"
        "import pytorch_distributed_training_tpu_torch.resilience.anomaly\n"
        "import pytorch_distributed_training_tpu_torch.resilience.recovery\n"
        "import pytorch_distributed_training_tpu_torch.data.device_cache\n"
        "import pytorch_distributed_training_tpu_torch.data.token_cache\n"
        "import pytorch_distributed_training_tpu_torch.utils.backoff\n"
        "import pytorch_distributed_training_tpu_torch.utils.supervisor\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"({blocked},) and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config, create_model, generate,
    )
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT2(GPT2Config(num_layers=1, hidden_dim=16, num_heads=2,
                            vocab_size=32, max_seq_len=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, num_slots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, [[1, 2]], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("gpt2")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        ServingEngine(model, num_slots=2, device="cuda")
