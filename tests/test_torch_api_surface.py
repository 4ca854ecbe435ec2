"""The PyTorch port keeps the JAX package's public surface.

Every module of ``yolo_ad_refine_tpu/`` is parsed with ``ast`` (nothing of
JAX is imported), and so is the port's module at the same path. Each public
top-level function or class, each public method of such a class, and each
name a package ``__init__`` re-exports from the package itself must exist
in the port, unless ``EXCEPTIONS`` names it with the reason. A module the
port leaves out on purpose is named in ``NOT_PORTED`` and in ROADMAP's "Not
ported on purpose". ``hub`` raises as the JAX one does.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "yolo_ad_refine_tpu"
PORT = REPO / "yolo_ad_refine_tpu_torch"

_SETUP = "flax builds submodules in setup(); a torch module builds them in __init__"
_MESH = ("a jax.sharding mesh helper; the port runs DDP / FSDP2 over torch.distributed "
         "(parallel/__init__.py wrap_model, parallel/multihost.py)")
_TF = ("a JAX / TensorFlow export format; the port raises UnsupportedFormat for it "
       "(ROADMAP catalogue item 11)")
_TORCH_HAS_IT = "a flax / jnp wrapper of what torch.nn and torch.nn.functional provide"

# module path under the package: why the port has no such module
NOT_PORTED = {
    "ops/s2d_stem.py": "an XLA-level rewrite of the stem against the TPU's 128-lane padding",
    "ops/s2d_prologue.py": "an XLA-level rewrite of the stem against the TPU's 128-lane padding",
    "ops/ayhead_fused.py": "an XLA-level rewrite of the AYHead against the TPU's lane padding",
    "utils/torch_import.py": "the port's weights are torch already; its tests use the "
                             "importer as the JAX side",
    "utils/metrics_np.py": "its three helpers live in the port's utils/metrics.py",
    "ops/deform_mxu2.py": "K1's Pallas kernels; the port's K1 is csrc/deform_conv.cu behind "
                          "ops/deform.py",
    "ops/nms_pallas.py": "K4 / K5's Pallas kernels; the port's are csrc/nms.cu behind ops/nms.py",
}

# "module path:qualified name": why the port has no such name
EXCEPTIONS = {
    "engine/exporter.py:Exporter.export_stablehlo": _TF,
    "engine/exporter.py:Exporter.export_saved_model": _TF,
    "engine/exporter.py:Exporter.export_tflite": _TF,
    "engine/exporter.py:Exporter.export_pb": _TF,
    "models/model.py:DetectionGraph": "the flax graph module; the port's DetectionModel is the "
                                      "nn.Module that runs the rows",
    "models/model.py:DetectionModel.init": "flax's variables API; the port draws weights in "
                                           "models/model.py init_weights",
    "models/model.py:DetectionModel.apply": "flax's variables API; the port's model holds its "
                                            "weights and runs as forward",
    "models/sam/model.py:SAMModel.setup": _SETUP,
    "models/sam/modules.py:PositionEmbeddingRandom.setup": _SETUP,
    "models/sam/modules.py:PromptEncoder.setup": _SETUP,
    "models/sam/modules.py:PositionEmbeddingRandom.with_coords": "the port keeps the reference's "
                                                                "name, forward_with_coords",
    "models/sam/modules.py:DownAttention": "the port keeps the reference's name, Attention "
                                           "(with downsample_rate)",
    "models/sam/sam2.py:SAM2Net.setup": _SETUP,
    "models/sam/sam2.py:SAM2Net.init_aux": "a flax pass that makes lazily created params exist; "
                                           "torch creates them in __init__",
    "models/sam/tiny_encoder.py:ConvBN": "the port keeps the reference's name, Conv2d_BN",
    "models/sam/tiny_encoder.py:BiasedAttention": "the port keeps the reference's name, "
                                                  "Attention",
    "nn/block.py:C3k.inner_block": "flax's factory for the compact __call__; the torch block "
                                   "builds its inner blocks in __init__",
    "nn/block.py:adaptive_avg_pool2d": _TORCH_HAS_IT,
    "nn/block.py:adaptive_max_pool2d": _TORCH_HAS_IT,
    "nn/block.py:resize_bilinear_align_corners": _TORCH_HAS_IT,
    "nn/common.py:BatchNorm": _TORCH_HAS_IT,
    "nn/common.py:PlainConv2d": _TORCH_HAS_IT,
    "nn/common.py:PlainConvTranspose2d": _TORCH_HAS_IT,
    "nn/common.py:Upsample": _TORCH_HAS_IT,
    "nn/common.py:conv2d": _TORCH_HAS_IT,
    "nn/common.py:hardswish": _TORCH_HAS_IT,
    "nn/common.py:silu": _TORCH_HAS_IT,
    "ops/deform.py:modulated_deform_conv2d_dense": "the TPU's dense hat-weight formulation; the "
                                                   "port computes the bounded DCN directly (K2 / "
                                                   "K3, ops/deform_mxu.py, ops/deform_pallas.py)",
    "parallel/__init__.py:make_mesh": _MESH,
    "parallel/__init__.py:make_mesh_for_batch": _MESH,
    "parallel/__init__.py:batch_sharding": _MESH,
    "parallel/__init__.py:replicated": _MESH,
    "parallel/__init__.py:state_shardings": _MESH,
    "parallel/__init__.py:shard_batch": _MESH,
    "parallel/__init__.py:shard_state": _MESH,
    "parallel/__init__.py:make_parallel_train_step": _MESH,
    "parallel/multihost.py:global_mesh": _MESH,
    "parallel/multihost.py:shard_host_local_batch": _MESH,
    "train/classify.py:ClassificationTrainer.validate": "a function of the module in the port, "
                                                        "train/classify.py validate",
    "train/optim.py:ema_update": "a pytree update under jit; the port's EMA is ModelEMA.update",
    "train/pose.py:PoseLossOutputs": "the jitted loss's NamedTuple; the port's loss returns "
                                     "(total, components) tensors",
    "train/segment.py:SegLossOutputs": "the jitted loss's NamedTuple; the port's loss returns "
                                       "(total, components) tensors",
    "train/segment.py:crop_mask_weights": "the port's loss crops with ops/masks.py crop_mask, "
                                          "the same window",
    "train/step.py:TrainState": "flax's TrainState; the port's step is train/step.py TrainStep "
                                "over a torch optimizer",
    "train/step.py:TrainState.create": "flax's TrainState; see train/step.py TrainStep",
    "train/step.py:TrainState.variables": "flax's TrainState; see train/step.py TrainStep",
    "train/step.py:TrainState.ema_variables": "flax's TrainState; see train/optim.py ModelEMA",
    "train/step.py:make_train_step": "builds the jitted step; the port's is train/step.py "
                                     "TrainStep",
    "utils/autobatch.py:device_memory_limit": "reads a JAX device's bytes_limit; the port's "
                                              "autobatch measures the card's peaks of real steps",
}

MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def public_names(path: Path, package: str) -> set[str]:
    """The public top-level functions and classes of the module at ``path``,
    ``Class.method`` for their public methods, and, in an ``__init__.py``,
    the names it imports from ``package`` itself (its re-exports)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not m.name.startswith("_"))
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom) and \
                (node.module or "").split(".")[0] == package:
            names.update(a.asname or a.name for a in node.names)
    return names


def test_every_jax_module_is_walked():
    assert len(MODULES) > 90
    assert "ops/boxes.py" in MODULES and "hub/__init__.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_has_the_jax_public_names(rel):
    if rel in NOT_PORTED:
        roadmap = (REPO / "ROADMAP.md").read_text()
        assert not (PORT / rel).exists(), f"{rel} is ported: take it out of NOT_PORTED"
        assert NOT_PORTED[rel] and (rel in roadmap or rel.endswith(("deform_mxu2.py",
                                                                    "nms_pallas.py")))
        return
    assert (PORT / rel).exists(), f"the port has no {rel}"
    want = public_names(JAX / rel, "yolo_ad_refine_tpu")
    have = public_names(PORT / rel, "yolo_ad_refine_tpu_torch")
    missing = sorted(n for n in want - have if f"{rel}:{n}" not in EXCEPTIONS)
    assert not missing, f"{rel}: the port lacks {missing}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS))
def test_each_exception_has_a_reason_and_is_still_needed(key):
    rel, name = key.split(":")
    assert EXCEPTIONS[key].strip()
    assert name in public_names(JAX / rel, "yolo_ad_refine_tpu"), f"JAX has no {key}"
    assert name not in public_names(PORT / rel, "yolo_ad_refine_tpu_torch"), \
        f"the port has {key} now: take it out of EXCEPTIONS"


@pytest.mark.parametrize("call", ["login", "export_model"])
def test_hub_raises_as_in_jax(call):
    from yolo_ad_refine_tpu import hub as jax_hub
    from yolo_ad_refine_tpu_torch import hub

    assert hub.HUB_UNAVAILABLE == jax_hub.HUB_UNAVAILABLE
    for module in (hub, jax_hub):
        with pytest.raises(ConnectionError, match="network access"):
            getattr(module, call)()


def test_hub_logout_and_check_dataset_run_offline(tmp_path):
    from yolo_ad_refine_tpu_torch import hub
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    hub.logout()
    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=2, imgsz=64, seed=0)
    info = hub.check_dataset(data)
    assert info["nc"] == len(info["names"])
