"""The PyTorch port keeps the JAX package's public surface.

Every module of ``yolo_ad_refine_tpu/`` is parsed with ``ast`` (nothing of
JAX is imported), and so is the port's module at the same path. Each public
top-level function or class, each public method of such a class, and each
name a package ``__init__`` re-exports from the package itself must exist
in the port, unless ``EXCEPTIONS`` names it with the reason. A module the
port leaves out on purpose is named in ``NOT_PORTED`` and in ROADMAP's "Not
ported on purpose". ``hub`` raises as the JAX one does.

The signatures are walked too: for each public function, and each public
method or ``__init__`` of a public class, that both modules define, a call
written for the JAX function must bind the same in the port's. JAX's
positional parameters lead the port's with the same names, in the same
order, with the same defaults (``jnp.`` read as ``torch.``; a port default
where JAX has none breaks no JAX call); a parameter the port adds comes
after them with a default, or is keyword-only; JAX's keyword-only
parameters are the port's with the same defaults; ``*args`` / ``**kwargs``
where JAX takes them. A kept difference is named in
``SIGNATURE_EXCEPTIONS`` with its reason.
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

_DTYPE = ("flax's compute dtype: a torch module computes in its parameters' dtype "
          "(.to(dtype), autocast), and the port's builders take the device in its place")
_RNG = "flax's rng key: the port draws from a seed or a torch.Generator"
_FACTORY = ("flax's factory of the i-th inner block for the compact __call__; the torch block "
            "builds its blocks in __init__ and needs no index")
_STATE = "flax's TrainState: the port keeps the model, its ModelEMA and the torch optimizer"
_FORMATS = ("the port's format names: it exports checkpoint, torch_export and torchscript "
            "(ROADMAP catalogue item 11), so no JAX format is its default")

# "module path:qualified name": why its parameters part from JAX's
SIGNATURE_EXCEPTIONS = {
    "engine/checkpoint.py:load_checkpoint": _DTYPE,
    "engine/checkpoint.py:load_train_state": _STATE,
    "engine/checkpoint.py:save_checkpoint": _STATE,
    "models/model.py:DetectionModel.__init__": _DTYPE,
    "models/parser.py:parse_model_yaml": _DTYPE,
    "models/sam/model.py:SAM.__init__": _DTYPE,
    "models/sam/model.py:build_sam": _DTYPE,
    "models/sam/sam2.py:SAM2Predictor.__init__": _DTYPE,
    "models/sam/sam2.py:SAM2VideoPredictor.__init__": _DTYPE,
    "models/sam/sam2.py:build_sam2": f"{_DTYPE}; {_RNG}",
    "models/yolo.py:YOLO.__init__": "task=None takes the task from the head (a given task is "
                                    "checked against it), where JAX defaults to 'detect'",
    "models/yolo.py:YOLO.export": _FORMATS,
    "nn/block.py:C2PSA.inner_block": _FACTORY,
    "nn/block.py:C2f.inner_block": _FACTORY,
    "nn/block.py:C3.inner_block": _FACTORY,
    "nn/block.py:C3k2.inner_block": _FACTORY,
    "nn/block.py:C3k2MLCA.inner_block": _FACTORY,
    "nn/block.py:C3kMLCA.inner_block": _FACTORY,
    "nn/conv_extras.py:C2fCIB.inner_block": _FACTORY,
    "nn/tssa.py:C2AdaptiveTSSAEnhanced.inner_block": _FACTORY,
    "nn/tssa.py:C2PSAEDFFN.inner_block": _FACTORY,
    "nn/tssa.py:C2PTSSA.inner_block": _FACTORY,
    "nn/tssa.py:C2ProgressiveTSSAFusion1.inner_block": _FACTORY,
    "nn/tssa.py:C2SFA.inner_block": _FACTORY,
    "nn/tssa.py:C2TSSADyTMonaEDFFN.inner_block": _FACTORY,
    "nn/head.py:decode_detections": "a renamed layout: JAX's feats_nhwc are the port's NCHW "
                                    "feats",
    "ops/nms.py:non_max_suppression": "use_pallas, JAX's switch between its Pallas kernel and "
                                      "plain JAX: the port takes its kernel on the card and its "
                                      "plain version on the CPU, by the tensor's device",
    "train/optim.py:build_optimizer": "a renamed layout: JAX's params pytree is the port's "
                                      "named_params, (name, parameter) pairs",
    "train/optim.py:param_group_label": "a renamed layout: JAX's (flax path, leaf) is the "
                                        "port's (dotted name, parameter)",
    "train/rtdetr.py:RTDETRLoss.match": "the port's matcher takes each decoder level's "
                                        "(boxes, scores) at once and solves all of them in one "
                                        "LAP launch (csrc/lap.cu)",
    "train/rtdetr.py:make_cdn_group": _RNG,
    "utils/autobatch.py:autobatch": "the port measures the card's peak memory of a real step "
                                    "(step, on device), where JAX reads compiled programs' "
                                    "memory analysis; ROADMAP intended differences, Tools",
    "utils/benchmarks.py:benchmark": _FORMATS,
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


def signatures(path: Path) -> dict:
    """{qualified name: signature} of the public functions of the module at
    ``path`` and the public methods and ``__init__`` of its public classes;
    a signature is (positional [(name, default source or None)], keyword-only
    {name: default source or None}, takes *args, takes **kwargs)."""

    def sig(fn):
        a = fn.args
        pos = [x.arg for x in a.posonlyargs + a.args if x.arg not in ("self", "cls")]
        given = [ast.unparse(d) for d in a.defaults][-len(pos):] if pos else []
        defaults = [None] * (len(pos) - len(given)) + given
        kw = {x.arg: None if d is None else ast.unparse(d)
              for x, d in zip(a.kwonlyargs, a.kw_defaults)}
        return list(zip(pos, defaults)), kw, a.vararg is not None, a.kwarg is not None

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not node.name.startswith("_"):
            out[node.name] = sig(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.update((f"{node.name}.{m.name}", sig(m)) for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and (m.name == "__init__" or not m.name.startswith("_")))
    return out


def _default(src):
    return None if src is None else src.replace("jnp.", "torch.")


def binding_faults(jax_sig, port_sig) -> list[str]:
    """Where a call written for the JAX signature would bind otherwise in
    the port's (the rule of the module docstring); empty where none."""
    (jpos, jkw, jvar, jkwargs), (ppos, pkw, pvar, pkwargs) = jax_sig, port_sig
    faults = []
    for i, (name, default) in enumerate(jpos):
        if i >= len(ppos):
            faults.append(f"no positional parameter {i} ({name})")
            continue
        pname, pdefault = ppos[i]
        if pname != name:
            faults.append(f"positional parameter {i} is {pname}, JAX's {name}")
        elif default is not None and _default(default) != _default(pdefault):
            faults.append(f"{name}={pdefault}, JAX's {name}={default}")
    faults += [f"{name} has no default" for name, d in ppos[len(jpos):] if d is None]
    for name, default in jkw.items():
        if name not in pkw and name not in dict(ppos):
            faults.append(f"no keyword {name}")
        elif _default(default) != _default(pkw.get(name, dict(ppos).get(name))):
            faults.append(f"{name}={pkw.get(name)}, JAX's {name}={default}")
    faults += [f"keyword-only {n} has no default" for n, d in pkw.items()
               if d is None and n not in jkw]
    faults += ["no *args"] * (jvar and not pvar) + ["no **kwargs"] * (jkwargs and not pkwargs)
    return faults


def test_binding_faults_catch_what_misbinds():
    jax_sig = ([("x", None), ("bias", "None"), ("k", "3")], {}, False, False)
    assert binding_faults(jax_sig, ([("x", None), ("bias", "None"), ("k", "3")],
                                    {"radius": "None"}, False, False)) == []
    assert binding_faults(jax_sig, ([("x", None), ("radius", "None")], {}, False, False)) == [
        "positional parameter 1 is radius, JAX's bias", "no positional parameter 2 (k)"]
    assert binding_faults(jax_sig, ([("x", None), ("bias", "None"), ("k", "5")], {}, False,
                                    False)) == ["k=5, JAX's k=3"]
    assert binding_faults(([("a", "jnp.float32")], {}, True, False),
                          ([("a", "torch.float32"), ("device", None)], {"r": None}, False,
                           False)) == ["device has no default", "keyword-only r has no default",
                                       "no *args"]


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


@pytest.mark.parametrize("rel", MODULES)
def test_port_signatures_bind_jax_calls(rel):
    if rel in NOT_PORTED:
        return
    want = signatures(JAX / rel)
    have = signatures(PORT / rel)
    faults = {name: f for name in sorted(set(want) & set(have))
              if f"{rel}:{name}" not in SIGNATURE_EXCEPTIONS
              and (f := binding_faults(want[name], have[name]))}
    assert not faults, f"{rel}: a JAX-style call binds otherwise in the port: {faults}"


@pytest.mark.parametrize("key", sorted(SIGNATURE_EXCEPTIONS))
def test_each_signature_exception_has_a_reason_and_is_still_needed(key):
    rel, name = key.split(":")
    assert SIGNATURE_EXCEPTIONS[key].strip()
    want, have = signatures(JAX / rel), signatures(PORT / rel)
    assert name in want and name in have, f"{key} is not in both packages"
    assert binding_faults(want[name], have[name]), \
        f"{key} binds as JAX's now: take it out of SIGNATURE_EXCEPTIONS"


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
