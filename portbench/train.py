"""The training runner: ``YOLO.train``'s own trainer loop, its loader and
``TrainStep``, at the traffic's batch.

Set-up makes the weights on the card from the seed, writes the traffic's
seeded images under the run's TMPDIR (as many as the window can step at
``max_images_per_s``, so that it lies inside the first epoch), and starts
``YOLO.train`` with the traffic's settings (``val``, ``save`` and ``plots``
off). Its first ``warmup_steps`` steps are set-up too; the callbacks keep
what the check needs from the first three: their host batches, the
components of their losses, the momentum buffers after the first step and
the parameters and EMA after the third. The window then starts at a step's
start (after a synchronise) and closes at the end of the step during which
``--seconds`` passed (after a synchronise): images stepped over its
seconds. With ``trace`` a profiled tail of ``trace_steps`` steps follows.
A callback then stops the trainer.

The check, once the program is freed: the reference steps the same
weights through the same three batches in fp32 and the program is held to
it, where the configuration gives a limit, by the first step's output of
a shallow row (row 1, two convolutions deep, where bf16 and fp8 part) and
of the head (``maps_rel``: the seeded network carries any rounding to a
floor of 5-13 % there) and, leaf by leaf, by the change after three steps
of the parameters and of the EMA: the median leaf's gap (bf16 autocast
alone moves the worst leaf, a BatchNorm bias or scale whose gradient is a
sum that cancels, by a fifth or more). A number without a limit is
printed, as are the loss components' gap and the first gradient's, which
the control reads as sound runs do.
"""

from __future__ import annotations

import gc
import math
import shutil
import sys
import threading
import time
from pathlib import Path

from portbench.harness import held
from portbench.reference.train import ROW, ROW_IMAGES
from portbench.trace import Spans, Trace


class WindowClosed(BaseException):
    """Raised from a trainer callback to stop the run once it has measured.
    The trainer's callback runner logs and drops an ``Exception``, so the
    harness's own signals derive from ``BaseException``."""


class HarnessFault(BaseException):
    """An error inside a harness callback, carried past the callback runner."""


def guarded(fn):
    def call(trainer):
        try:
            fn(trainer)
        except Exception as e:  # noqa: BLE001 - re-raised past the trainer's runner
            raise HarnessFault(f"{fn.__name__}: {type(e).__name__}: {e}") from e
    return call


def dataset(cfg: dict, tr: dict, seed: int, seconds: float, root: Path) -> tuple[Path, int]:
    import yaml

    from portbench.images import write_split

    b = tr["batch"]
    steps = tr["warmup_steps"] + math.ceil(tr["max_images_per_s"] * seconds / b) + \
        tr["trace_steps"] + 2
    n = steps * b
    shutil.rmtree(root, ignore_errors=True)
    size, nc = tr["image_size"], cfg["nc"]
    write_split(root / "train", n, seed, size, nc, tr["objects"], tr["radius"])
    write_split(root / "val", 2, seed + 1, size, nc, tr["objects"], tr["radius"])
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "train/images",
                                    "val": "val/images",
                                    "names": {i: f"class{i}" for i in range(nc)}}))
    return data, n


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    import torch

    from portbench.harness import scratch_dir
    from portbench.serve import model_dict
    from portbench.weights import make_state
    from yolo_ad_refine_tpu_torch import YOLO

    cfg, tr = cell["config"], cell["traffic"]
    b, w_steps = tr["batch"], tr["warmup_steps"]
    root = scratch_dir() / "train"
    marks = [("start", t_start), ("imports", time.perf_counter())]
    data, n_images = dataset(cfg, tr, seed, seconds, root)
    marks.append((f"{n_images} images written", time.perf_counter()))
    yolo = YOLO(model_dict(cfg), device=device, imgsz=cfg["imgsz"])
    yolo.model.load_state_dict(make_state(cfg, seed, device))
    marks.append(("program built, weights loaded", time.perf_counter()))

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    spans = Spans()
    st = {"k": 0, "outputs": [], "batches": [], "maps": [], "t0": None, "window_steps": 0}
    trace_ctx = []

    def on_start(trainer):
        if trainer.batch_size != b or trainer.accumulate != 1:
            raise RuntimeError(f"the trainer runs batch {trainer.batch_size} with accumulate "
                               f"{trainer.accumulate}, not {b} and 1")
        step = trainer.train_step

        def recorded(batch):
            m = step(batch)
            if st["k"] <= 3:
                st["outputs"].append(m["components"].detach().float().cpu())
            return m

        trainer.train_step = recorded

        def first_maps(_module, _inputs, output):  # the first three steps' head maps
            st["maps"].append([m.detach().float().cpu() for m in output])
            if len(st["maps"]) == 3:
                hook.remove()

        hook = trainer.model.register_forward_hook(first_maps)

        def first_row(_module, _inputs, output):
            st["row1"] = output[:ROW_IMAGES].detach().float().cpu()
            row_hook.remove()

        row_hook = trainer.model.model[ROW].register_forward_hook(first_row)
        marks.append(("trainer set up", time.perf_counter()))

    def on_batch_start(trainer):
        st["k"] += 1
        k = st["k"]
        if k <= 3:
            st["batches"].append(trainer.batch)
        if k == 2:
            marks.append(("first step", time.perf_counter()))
        if k == w_steps + 1:
            sync()
            st["t0"] = time.perf_counter()
            st["setup_s"] = st["t0"] - t_start
            marks.append((f"{w_steps} warm-up steps", st["t0"]))
            print("set-up: " + ", ".join(f"{n} {t - p:.2f} s" for (_, p), (n, t) in
                                         zip(marks, marks[1:])), file=sys.stderr)
        if st["t0"] is not None:
            if k > w_steps + 1:
                spans.end("pb.data")
            if st.get("t1") is not None and not trace_ctx:
                sync()
                spans.tracing = True
                trace_ctx.append(Trace().__enter__())
                spans.begin(Trace.WINDOW)
            spans.begin("pb.step")

    def on_batch_end(trainer):
        k = st["k"]
        if k == 1:
            opt = trainer.optimizer.opt
            st["buf1"] = {n: opt.state[p]["momentum_buffer"].detach().to("cpu", copy=True)
                          for n, p in trainer.model.named_parameters() if p in opt.state}
        if k == 3:
            st["p3"] = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
            st["ema3"] = {n: p.detach().to("cpu", copy=True) for n, p in trainer.ema.ema.named_parameters()}
        if st["t0"] is None:
            return
        spans.end("pb.step")
        spans.begin("pb.data")
        if st.get("t1") is None:
            if time.perf_counter() - st["t0"] >= seconds:
                sync()
                st["t1"] = time.perf_counter()
                st["window_steps"] = k - w_steps
                spans.freeze()
                if not trace:
                    raise WindowClosed
        elif k - w_steps - st["window_steps"] >= tr["trace_steps"]:
            sync()
            spans.end(Trace.WINDOW)
            spans.tracing = False
            st["trace"] = trace_ctx.pop()
            raise WindowClosed
        if k >= n_images // b:
            raise RuntimeError(f"the epoch's {n_images // b} steps ran out before the window "
                               f"closed: raise max_images_per_s")

    yolo.add_callback("on_train_start", guarded(on_start))
    yolo.add_callback("on_train_batch_start", guarded(on_batch_start))
    yolo.add_callback("on_train_batch_end", guarded(on_batch_end))
    threads = set(threading.enumerate())
    try:
        yolo.train(data=str(data), batch=b, imgsz=cfg["imgsz"], project=str(root / "runs"),
                   name="train", exist_ok=True, seed=seed, val=False, save=False, plots=False,
                   **tr["settings"])
    except WindowClosed:
        pass
    traced = None
    if "trace" in st:
        t = st.pop("trace")
        t.__exit__(None, None, None)
        traced = t.summary
        traced["steps"] = tr["trace_steps"]
        traced["images"] = tr["trace_steps"] * b
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    images, window_s = st["window_steps"] * b, st["t1"] - st["t0"]
    out = {"attempted": images, "window_s": window_s, "peak_bytes": peak, "spans": spans,
           "traced": traced, "steps": st["window_steps"],
           "e2e": {"train_images_per_s": images / window_s, "peak_mem_gib": peak / 2 ** 30,
                   "setup_s": st["setup_s"]}}
    keep = {k: st[k] for k in ("outputs", "batches", "row1", "maps", "buf1", "p3", "ema3")}
    st.clear()
    del yolo
    gc.collect()
    wait_threads(threads)
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out["numbers"] = check(cfg, tr, seed, n_images // b, keep, device)
    out["checks"] = held(out["numbers"], cfg["limits"]["train"])
    out["check_s"] = time.perf_counter() - t_check
    shutil.rmtree(root, ignore_errors=True)
    return out


def wait_threads(before: set, timeout: float = 60.0) -> None:
    """Wait for the loader's threads to end."""
    t_end = time.monotonic() + timeout
    for t in set(threading.enumerate()) - before:
        t.join(max(0.0, t_end - time.monotonic()))
        if t.is_alive():
            raise RuntimeError(f"thread {t.name} outlived the trainer")


def _gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(b, floor)


def check(*args) -> dict:
    """The compared numbers of ``_check``, the reference run with TF32 off."""
    from portbench.harness import tf32_off

    with tf32_off():
        return _check(*args)


def dcn_leaves(ref, names) -> list[str]:
    """Of ``names``, the leaves of the head's deformable convs (the weight
    whose gradient K1 bwd makes, their norms) and of the conv that makes
    their offsets and masks (whose gradient comes through K1 bwd)."""
    from portbench.reference.modules import DyDCNv2

    i = len(ref.model) - 1
    parts = {n for n, m in ref.model[i].named_children() if isinstance(m, DyDCNv2)}
    parts.add("spatial_conv_offset")
    return [n for n in names if n.startswith(f"model.{i}.") and n.split(".")[2] in parts]


def _check(cfg: dict, tr: dict, seed: int, nb: int, keep: dict, device: str) -> dict:
    """The program's first three steps against the reference's."""
    import statistics

    import torch

    from portbench.reference.model import build
    from portbench.reference.loss import detection_loss
    from portbench.reference.train import Trainer, group_of, targets
    from portbench.weights import make_state

    ref = build(cfg["yaml_path"], cfg["scale"], device=device)
    ref.load_state_dict(make_state(cfg, seed, device))
    ref.checkpointed = True
    p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    h = tr["settings"]
    trainer = Trainer(ref, h, nb, tr["batch"], cfg["nc"])
    loss_gap = 0.0
    for k, batch in enumerate(keep["batches"][:3]):
        want = trainer.step(batch).cpu()
        loss_gap = max(loss_gap, ((keep["outputs"][k] - want).abs() / want.abs()).max().item())
    row_rel = 1.0  # a first forward of another shape than the reference's
    if keep["row1"].shape == trainer.first_row.shape:
        row_rel = (torch.linalg.vector_norm(keep["row1"].to(device) - trainer.first_row)
                   / torch.linalg.vector_norm(trainer.first_row)).item()
    maps_rel = 1.0
    if [m.shape for m in keep["maps"][0]] == [m.shape for m in trainer.first_maps]:
        diff = sum(torch.linalg.vector_norm(a.to(device) - b).square() for a, b in
                   zip(keep["maps"][0], trainer.first_maps))
        ref_sq = sum(torch.linalg.vector_norm(b).square() for b in trainer.first_maps)
        maps_rel = (diff / ref_sq).sqrt().item()
    loss_stage = 0.0  # the loss alone: the reference's over the program's own head maps
    for k, (maps, batch) in enumerate(zip(keep["maps"], keep["batches"][:3])):
        if maps[0].shape[0] != len(batch["img"]):
            loss_stage = 1.0  # a forward over another batch than the loader's
            break
        want, _ = detection_loss([m.to(device) for m in maps], *targets(batch, device), cfg["nc"])
        loss_stage = max(loss_stage, ((keep["outputs"][k] - want.cpu()).abs()
                                      / want.cpu().abs()).max().item())
    wd = trainer.wd

    def norm(t):
        return torch.linalg.vector_norm(t.to(device).float()).item()

    g_ref = {n: norm(g) for n, g in trainer.first_grad.items()}
    g_prog = {}
    for n, buf in keep["buf1"].items():
        g = buf.to(device)
        if group_of(n, p0[n]) == "decay":
            g = g - wd * p0[n]
        g_prog[n] = norm(g)
    med_g = statistics.median(g_ref.values())
    gaps = {"grad": {n: _gap(g_prog.get(n, 0.0), v, med_g) for n, v in g_ref.items()}}
    moved = [n for n, v in g_ref.items() if v >= 1e-3 * med_g]
    for label, got in (("change", keep["p3"]), ("ema_change", keep["ema3"])):
        want_t = dict(ref.named_parameters()) if label == "change" else trainer.ema
        d_ref = {n: norm(want_t[n].detach() - p0[n]) for n in moved}
        d_prog = {n: norm(got[n].to(device) - p0[n]) for n in moved}
        med = statistics.median(d_ref.values())
        gaps[label] = {n: _gap(d_prog[n], d_ref[n], med) for n in moved}
    for label, g in gaps.items():  # the worst leaf of all, for the record
        worst = max(g, key=g.get)
        print(f"{label}: median leaf gap {statistics.median(g.values()):.6g}, worst "
              f"{g[worst]:.6g} ({worst})", file=sys.stderr)
    dcn = dcn_leaves(ref, moved)
    return {"row1_rel": row_rel, "maps_rel": maps_rel, "loss_rel": loss_gap,
            "loss_stage_rel": loss_stage,
            "grad_leaf": statistics.median(gaps["grad"].values()),
            "change_leaf": statistics.median(gaps["change"].values()),
            "ema_change_leaf": statistics.median(gaps["ema_change"].values()),
            "dcn_grad_leaf": max(gaps["grad"][n] for n in dcn),
            "dcn_change_leaf": max(gaps["change"][n] for n in dcn)}
