"""Data-parallel train steps of the PyTorch port (``parallel/``) on two gloo
ranks on the CPU, against one process and against the JAX package's step
on a 2-device mesh (conftest's virtual CPU devices).

The ranks are processes of ``tests/torch_parallel_worker.py`` with
torchrun's environment, started once for the file's four runs (TINY on
DDP and on FSDP2, the flagship, an OBB model), with a timeout of their
own: the process group's and the wait for the ranks. The global batch gives every box to rank 0's
half and none to rank 1's, so the ranks' local statistics differ (held
below): a BatchNorm that used its rank's statistics, or a loss that used
its rank's target_scores_sum, SlideLoss IoU or batch, would fail the
comparisons.

Limits, as ``test_torch_train_slice.py`` holds one process against JAX:
DDP against one process, the loss within 1e-6 relative and the params,
BN statistics and EMA within 1e-5 of max |ref| per tensor; DDP against the
JAX mesh, the loss and components within 1e-5, each gradient leaf within
1e-4 relative norm (a leaf whose fp32 sum cancels, where the port's own
fp32 gradient lies over 1e-4 from the same step in fp64, is held against
fp64: JAX within 4 times the port's distance), the params, BN statistics
and EMA within 1e-5; FSDP2 against DDP over two steps at 1e-5, as
``tests/test_fsdp.py`` holds the JAX package's FSDP against its DP. The
flagship (its MLCA mixes the batch, ``nn/block.py``) runs in fp64, where
DDP must meet one process to rounding: 1e-12 on the loss, 1e-10 on the
trainable parameters; the BN running statistics are fp32 sums in one
process (``nn/common.py``), so 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from torch_parallel_worker import run_ranks
from yolo_ad_refine_tpu.parallel import make_mesh, make_parallel_train_step, shard_batch
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.parallel import multihost as mh
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.obb import OBBLoss
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

TINY = {  # tests/test_fsdp.py's model
    "nc": 4,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}
TINY_OBB = {**TINY, "head": [[[2, 3, 4], 1, "OBB", ["nc", 1]]]}
NC, IMGSZ, BATCH, MAX_BOXES, STEPS = 4, 64, 4, 6, 2
OPT = dict(optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, epochs=1,
           nb=1, batch=BATCH, nbs=BATCH, warmup_epochs=0.0, warmup_momentum=0.8,
           warmup_bias_lr=0.1, cos_lr=False, nc=NC)
TIMEOUT_S = 240
KEYS = ("img", "cls", "bboxes", "mask")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def make_batches(steps: int, b: int, imgsz: int, seed: int = 0, obb: bool = False) -> dict:
    """``steps`` global batches stacked: boxes in the first half of each
    (rank 0's), none in the second (rank 1's)."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (steps, b, imgsz, imgsz, 3), dtype=np.uint8)
    xy = r.uniform(0, imgsz * 0.6, (steps, b, MAX_BOXES, 2))
    wh = r.uniform(imgsz * 0.1, imgsz * 0.35, (steps, b, MAX_BOXES, 2))
    boxes = (np.concatenate([xy + wh / 2, wh, r.uniform(-1.2, 1.2, (steps, b, MAX_BOXES, 1))], -1)
             if obb else np.concatenate([xy, xy + wh], -1)).astype(np.float32)
    cls = r.integers(0, NC, (steps, b, MAX_BOXES, 1)).astype(np.float32)
    mask = np.zeros((steps, b, MAX_BOXES, 1), np.float32)
    mask[:, : b // 2, :4] = 1.0
    return {"img": img, "cls": cls, "bboxes": boxes * mask, "mask": mask}


def one_process(model, batches: dict, loss_cls=DetectionLoss) -> tuple[list, list]:
    """The same steps in this process: their metrics and the model / EMA
    state after each."""
    opt, _, _ = build_optimizer(model.named_parameters(), **OPT)
    ema = ModelEMA(model)
    step = TrainStep(model, loss_cls(nc=NC, strides=model.strides), opt, ema)
    metrics, states = [], []
    for s in range(len(batches["img"])):
        metrics.append(step({k: batches[k][s] for k in KEYS}))
        states.append({"state": copy.deepcopy(model.state_dict()),
                       "ema": copy.deepcopy(ema.ema.state_dict())})
    return metrics, states


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def hold_state(got: dict, want: dict, tol: float, keys=None) -> None:
    bad = [f"{k}: {rel_err(got[k], v):.2e}" for k, v in want.items()
           if v.dtype.is_floating_point and (keys is None or k in keys)
           and rel_err(got[k], v) > tol]
    assert not bad, bad[:10]


def port_like(variables: dict, cfg=TINY) -> DetectionModel:
    m = DetectionModel(cfg)
    load_jax_variables(m, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    m.probe_strides(IMGSZ)
    return m


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four two-rank runs, {name: (records by rank, rank 0's state)},
    with TINY's JAX-randomised weights and variables."""
    tmp = tmp_path_factory.mktemp("parallel")
    jm, shapes = jax_shapes(TINY, IMGSZ)
    variables = randomize(shapes, seed=5)
    port = port_like(variables)
    torch.save(port.state_dict(), tmp / "weights.pt")
    batches = {"tiny": make_batches(STEPS, BATCH, IMGSZ), "flagship": make_batches(1, 2, 128, seed=1),
               "obb": make_batches(1, BATCH, IMGSZ, seed=3, obb=True)}
    for name, b in batches.items():
        np.savez(tmp / f"{name}.npz", **b)
    tiny = dict(cfg=TINY, weights=str(tmp / "weights.pt"), batches=str(tmp / "tiny.npz"),
                steps=STEPS)
    runs = {"ddp": tiny, "fsdp": {**tiny, "fsdp": True},
            "flagship": dict(cfg=FLAGSHIP, float64=True, seed=2, imgsz=128, steps=1,
                             batches=str(tmp / "flagship.npz"),
                             opt={**OPT, "batch": 2, "nbs": 2}),
            "obb": dict(cfg=TINY_OBB, seed=4, steps=1, batches=str(tmp / "obb.npz"))}
    recs = run_ranks({"scenario": "step", "out": str(tmp), "timeout_s": TIMEOUT_S,
                      "device": "cpu", "imgsz": IMGSZ, "nc": NC, "opt": OPT, "threads": 1,
                      "runs": [{**r, "out": str(tmp / n)} for n, r in runs.items()]}, world=2)
    out = {n: (r, torch.load(tmp / n / "state.pt")) for n, r in zip(runs, recs)}
    out.update(variables=variables, jm=jm, port=port, batches=batches)
    return out


@pytest.fixture(scope="module")
def tiny(ranks):
    """TINY's DDP and FSDP2 runs, the same steps in one process, and what
    the JAX mesh's step needs."""
    batches = ranks["batches"]["tiny"]
    one = one_process(copy.deepcopy(ranks["port"]).train(), batches)
    return {"variables": ranks["variables"], "jm": ranks["jm"], "batches": batches,
            "port": ranks["port"], "ddp": ranks["ddp"], "fsdp": ranks["fsdp"], "one": one}


def test_the_ranks_local_statistics_differ(tiny):
    """A missing sync would show: the ranks' own BN means and
    target_scores_sum differ (rank 1's half holds no box)."""
    recs, _ = tiny["ddp"]
    assert recs[0]["target_scores_sum"] > 0 == recs[1]["target_scores_sum"]
    assert np.abs(np.subtract(recs[0]["bn0_local_mean"], recs[1]["bn0_local_mean"])).max() > 1e-3
    assert [r["backend"] for r in recs] == ["gloo", "gloo"]
    assert recs[0]["wrapper"] == "DistributedDataParallel"
    assert tiny["fsdp"][0][0]["grads_sharded"] == "DTensor"


def test_ddp_step_matches_one_process(tiny):
    recs, saved = tiny["ddp"]
    metrics, states = tiny["one"]
    for s in range(STEPS):
        want = metrics[s]["loss"].item()
        for r in recs:  # every rank reports the global batch's loss and components
            assert abs(r["loss"][s] - want) <= 1e-6 * abs(want)
            np.testing.assert_allclose(r["components"][s], metrics[s]["components"].numpy(),
                                       rtol=1e-6, atol=1e-9)
        hold_state(saved["states"][s]["state"], states[s]["state"], 1e-5)
        hold_state(saved["states"][s]["ema"], states[s]["ema"], 1e-5)
    assert recs[0]["ema_updates"] == STEPS


def test_fsdp2_matches_ddp_over_two_steps(tiny):
    (d_recs, d_saved), (f_recs, f_saved) = tiny["ddp"], tiny["fsdp"]
    np.testing.assert_allclose(f_recs[0]["loss"], d_recs[0]["loss"], rtol=1e-5)
    for s in range(STEPS):
        hold_state(f_saved["states"][s]["state"], d_saved["states"][s]["state"], 1e-5)
        hold_state(f_saved["states"][s]["ema"], d_saved["states"][s]["ema"], 1e-5)


def test_ddp_step_matches_the_jax_mesh_step(tiny):
    variables, jm, batches = tiny["variables"], tiny["jm"], tiny["batches"]
    recs, saved = tiny["ddp"]
    batch = {k: batches[k][0] for k in KEYS}
    jloss = JaxDetectionLoss(nc=NC, strides=(8, 16, 32))
    mesh = make_mesh(2)

    def loss_of(params, stats, img, cls, bboxes, mask):
        feats, _ = jm.graph.apply({"params": params, "batch_stats": stats},
                                  img.astype(jnp.float32) / 255.0, train=True,
                                  mutable=["batch_stats", "diagnostics"])
        return jloss(feats, cls, bboxes, mask).total

    with mesh:
        sharded = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        jgrads = jax.jit(jax.grad(loss_of))(variables["params"], variables["batch_stats"],
                                            *(sharded[k] for k in KEYS))
        tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
        state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
        pstep = make_parallel_train_step(make_train_step(jm.graph, jloss, tx), mesh)
        jstate, jmetrics = pstep(state, sharded, jax.random.PRNGKey(0))
    assert abs(recs[0]["loss"][0] - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    np.testing.assert_allclose(recs[0]["components"][0], np.asarray(jmetrics["components"]),
                               rtol=1e-5, atol=1e-8)

    # the gradient leaves, with the fp64 rule for the ones whose fp32 sums cancel
    ref = dict(port_like({"params": jax.tree.map(np.asarray, jgrads),
                          "batch_stats": variables["batch_stats"]}).named_parameters())
    m64 = copy.deepcopy(tiny["port"]).double().train()
    DetectionLoss(nc=NC, strides=m64.strides)(
        m64(images_to_tensor(batch["img"], "cpu").double()),
        *(torch.from_numpy(batch[k]).double() for k in ("cls", "bboxes", "mask"))).total.backward()
    grads64 = {n: p.grad.detach() for n, p in m64.named_parameters()}
    grads = saved["grads"]
    assert set(grads) == set(ref)
    bad = []
    for name, want in ref.items():
        want, got, exact = want.detach().double(), grads[name], grads64[name]
        port_off = (got - exact).norm()
        if port_off <= 1e-4 * exact.norm():
            err = (got - want).norm() / want.norm().clamp(min=1e-30)
            if err > 1e-4:
                bad.append(f"{name}: {err:.2e} relative norm")
        elif (want - exact).norm() > 4 * port_off:
            bad.append(f"{name}: |jax - fp64| {(want - exact).norm():.2e}, "
                       f"|port - fp64| {port_off:.2e}")
    assert not bad, bad

    for key, ema in (("state", False), ("ema", True)):
        tree = {"params": jstate.ema_params if ema else jstate.params,
                "batch_stats": jstate.ema_batch_stats if ema else jstate.batch_stats}
        want = port_like(jax.tree.map(np.asarray, tree)).state_dict()
        hold_state(saved["states"][0][key], want, 1e-5)


def test_flagship_ddp_step_in_fp64_matches_one_process(ranks):
    """The flagship at 128 (its MLCA blocks average over the batch) in fp64:
    the ranks' global math against one process, to rounding."""
    batches = ranks["batches"]["flagship"]
    recs, saved = ranks["flagship"]
    model = build_detection_model(FLAGSHIP, nc=NC, device="cpu", seed=2, imgsz=128).double()
    opt, _, _ = build_optimizer(model.named_parameters(), **{**OPT, "batch": 2, "nbs": 2})
    ema = ModelEMA(model)
    m = TrainStep(model, DetectionLoss(nc=NC, strides=model.strides), opt, ema)(
        {k: batches[k][0] for k in KEYS})
    assert abs(recs[0]["loss"][0] - m["loss"].item()) <= 1e-12 * abs(m["loss"].item())
    trainable = {n for n, _ in model.named_parameters()}
    got = saved["states"][0]["state"]
    hold_state(got, model.state_dict(), 1e-10, keys=trainable)
    hold_state(got, model.state_dict(), 1e-6)


def test_obb_ddp_step_matches_one_process(ranks):
    batches = ranks["batches"]["obb"]
    recs, saved = ranks["obb"]
    model = build_detection_model(TINY_OBB, nc=NC, device="cpu", seed=4, imgsz=IMGSZ)
    assert model.task == "obb"
    metrics, states = one_process(model.train(), batches, OBBLoss)
    want = metrics[0]["loss"].item()
    assert all(abs(r["loss"][0] - want) <= 1e-6 * abs(want) for r in recs)
    assert recs[0]["target_scores_sum"] > 0 == recs[1]["target_scores_sum"]
    hold_state(saved["states"][0]["state"], states[0]["state"], 1e-5)
    hold_state(saved["states"][0]["ema"], states[0]["ema"], 1e-5)


def test_world_size_must_divide_the_batch(monkeypatch):
    monkeypatch.setattr(mh, "world_size", lambda: 3)
    monkeypatch.setattr(mh, "rank", lambda: 1)
    assert mh.per_host_batch_slice(12) == (4, 4, 8)
    with pytest.raises(ValueError, match="must divide by the world size 3"):
        mh.per_host_batch_slice(16)


def test_backend_follows_the_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mh.backend_for(torch.device("cpu"), 2)[0] == "gloo"
    assert mh.backend_for(torch.device("cuda", 0), 1)[0] == "nccl"
    backend, why = mh.backend_for(torch.device("cuda", 0), 2)
    assert backend == "gloo" and "share" in why


@pytest.mark.parametrize("env,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     {"launcher": "torchrun", "rank": 1, "world_size": 4, "local_rank": 1,
      "local_world_size": 2, "init_method": "env://"}),
    ({"YAT_COORDINATOR": "10.0.0.1:1234", "YAT_NUM_PROCESSES": "2", "YAT_PROCESS_ID": "1"},
     {"launcher": "YAT", "rank": 1, "world_size": 2, "local_rank": 0, "local_world_size": 1,
      "init_method": "tcp://10.0.0.1:1234"}),
    ({}, None),
])
def test_launcher_env(monkeypatch, env, want):
    set_launcher_env(monkeypatch, env)
    assert mh.launcher_env() == want


def set_launcher_env(monkeypatch, env: dict) -> None:
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "YAT_COORDINATOR",
              "YAT_NUM_PROCESSES", "YAT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


YAT_ENV = {"YAT_COORDINATOR": "10.0.0.1:1234", "YAT_NUM_PROCESSES": "2", "YAT_PROCESS_ID": "1"}


@pytest.mark.parametrize("cards,env,device,want", [
    (2, YAT_ENV, "cuda", None),  # one process for a host of two cards: raises
    (2, {**YAT_ENV, "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "cuda", "nccl"),
    (1, YAT_ENV, "cuda", "nccl"),
    (2, YAT_ENV, "cpu", "gloo"),
    (2, {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "cuda",
     "nccl"),
])
def test_yat_launch_takes_one_process_a_card(monkeypatch, cards, env, device, want):
    """Under the JAX package's YAT_* variables a process covers its host's
    devices; the port's covers one card, so a multi-card host needs each
    process's LOCAL_RANK. Where one is given (or there is one card, or the
    CPU), the process group starts as under torchrun."""
    set_launcher_env(monkeypatch, env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    started = []
    monkeypatch.setattr(mh.dist, "init_process_group",
                        lambda backend, **kw: started.append((backend, kw["rank"])))
    if want is None:
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
            mh.maybe_initialize_distributed(torch.device(device, 0) if device == "cuda"
                                            else torch.device(device))
        assert started == []
    else:
        assert mh.maybe_initialize_distributed(torch.device(device, 0) if device == "cuda"
                                               else torch.device(device))
        assert started == [(want, 1)]


def test_global_batch_is_one_switch_set_by_the_step(monkeypatch):
    """The global-batch statistics are taken only within the train step's
    ``global_batch()`` block, and only under a group of several ranks: a
    forward outside it (rank 0's validation, autobatch's probe) stays the
    rank's own."""
    from yolo_ad_refine_tpu_torch import parallel

    with parallel.global_batch():
        assert not parallel.in_global_batch()  # no process group here
    monkeypatch.setattr(parallel, "group_active", lambda: True)
    assert not parallel.in_global_batch()
    with parallel.global_batch():
        assert parallel.in_global_batch()
        with parallel.global_batch(False):
            assert not parallel.in_global_batch()
        assert parallel.in_global_batch()
    assert not parallel.in_global_batch()
