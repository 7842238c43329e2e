"""The parameter bridge from the reference, the port's import boundary, and
its refusal to run on the CPU when the card is asked for."""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.experiments.pipeline import target_config
from repro.models import Model as JModel
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import Model as TModel
from torch_parity import port_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    cfg = target_config()                      # 6 stacked layers, bf16 compute
    params, _ = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


def test_stacked_groups_become_one_dict_per_layer(reference):
    cfg, jp = reference
    tp = params_from_jax(jp, port_config(cfg), "cpu")
    assert len(tp["layers"]) == cfg.num_layers == jp["groups"][0]["attn"]["wq"].shape[0]
    for i, layer in enumerate(tp["layers"]):
        for block, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                want = jp["groups"][0][block][name][i]
                got = layer[block][name]
                # matmul weights are held in the compute dtype (bf16)
                assert got.dtype == torch.bfloat16
                assert torch.equal(got, torch.tensor(want).bfloat16())
        for name in ("norm1", "norm2"):
            assert layer[name].dtype == torch.float32
            assert np.array_equal(layer[name].numpy(), jp["groups"][0][name][i])
    assert torch.equal(tp["embed"], torch.tensor(jp["embed"]).bfloat16())
    assert tp["final_norm"].dtype == torch.float32


def test_checkpoint_npz_gives_the_same_parameters(reference, tmp_path):
    cfg, jp = reference
    path = tmp_path / "params.npz"
    jio.save(str(path), jp)
    with np.load(path) as data:
        from_npz = params_from_jax(dict(data), port_config(cfg), "cpu")
    from_tree = params_from_jax(jp, port_config(cfg), "cpu")
    flat_a = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), from_npz))
    flat_b = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), from_tree))
    assert len(flat_a) == len(flat_b) == 3 + 9 * cfg.num_layers
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))


def test_layer_count_mismatch_raises(reference):
    cfg, jp = reference
    with pytest.raises(ValueError):
        params_from_jax(jp, port_config(cfg.replace(num_layers=4)), "cpu")


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "compare_flash_decode.py"]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_cuda_model_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        TModel(port_config(target_config()), device="cuda")
    # and nothing is silently moved to the CPU
    assert TModel(port_config(target_config()), device="cpu").device.type == "cpu"
