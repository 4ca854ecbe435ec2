"""The serving runner: a closed loop of ``YOLO.predict`` calls.

Set-up makes a pool of seeded uint8 BGR images of the traffic's shapes,
the weights on the card from the seed (the class biases calibrated on the
pool's first images by the reference, ``weights.calibrate``), builds the
program's ``YOLO`` from the frozen model yaml at the configuration's scale
and warms the predictor on the traffic's own batch. The window then hands one batch of
``batch`` images to ``predict`` at a time, each batch the next images of a
seeded walk over the pool, and takes the next only when the ``Results``
are back: images/s over all the window's batches and its seconds, and the
95th percentile of the batch latencies. With ``trace`` a profiled tail of
``trace_batches`` batches follows the window.

The check, once the window has closed and the program is freed: for each
of ``check_batches`` batches drawn from the seed among the window's first
``check_within`` (whose head output a forward hook kept), the reference
recomputes the head's output from the same images (its own letterbox, the
flagship in fp32 with TF32 off) and the rows (its plain NMS over the
program's head output, its rescale), and holds the program to them: the
head's largest box and score gaps, and the count of rows that differ
(missing, extra, of another class or score, or a box off by more than
``ROW_PX``), which must be 0.
"""

from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np

from portbench.harness import held
from portbench.trace import Spans, Trace

# (cuDNN, matmul) TF32: PyTorch's defaults, what a user's serving process runs
PYTORCH_TF32 = (True, False)


def image_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng([seed, 1])
    shapes = traffic["shapes"]
    return [rng.integers(0, 256, (*shapes[i % len(shapes)], 3), dtype=np.uint8)
            for i in range(traffic["pool"])]


def batches(pool: list, batch: int, seed: int):
    """Endless batches of pool indices: seeded permutations, one after another."""
    rng = np.random.default_rng([seed, 2])
    walk = itertools.chain.from_iterable(rng.permutation(len(pool)) for _ in itertools.count())
    while True:
        yield [int(i) for i in itertools.islice(walk, batch)]


# A served row is the reference's row where its class and score are equal and
# its box is within the rescale's rounding: the program divides on the host, the
# reference on the card, one ulp apart at 1,920 px (1.2e-4); 1e-3 is 8 ulp.
ROW_PX = 1e-3


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        program=None) -> dict:
    import torch

    from portbench.weights import calibrate, make_state
    from yolo_ad_refine_tpu_torch import YOLO

    cfg, tr = cell["config"], cell["traffic"]
    kw = dict(conf=tr["conf"], iou=tr["iou"], max_det=tr["max_det"], batch=tr["batch"],
              imgsz=cfg["imgsz"])
    tf32 = bool(torch.backends.cudnn.allow_tf32), bool(torch.backends.cuda.matmul.allow_tf32)
    if tf32 != PYTORCH_TF32:
        raise SystemExit(f"the process runs cuDNN / matmul TF32 {tf32}, not PyTorch's "
                         f"defaults {PYTORCH_TF32}, which the configurations state")
    pool = image_pool(tr, seed)
    t_cal = time.perf_counter()  # the reference's seconds: not set-up
    cls_bias = calibrate(cfg, seed, pool[:tr["probe_images"]], tr["conf"], device)
    if device == "cuda":  # the peak is the program's, not the calibrating reference's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    calibrate_s = time.perf_counter() - t_cal
    state = make_state(cfg, seed, device, cls_bias)
    yolo = (program or YOLO)(model_dict(cfg), device=device, imgsz=cfg["imgsz"])
    yolo.model.load_state_dict(state)
    del state
    order = batches(pool, tr["batch"], seed)
    for _ in range(tr["warmup_batches"]):
        yolo.predict([pool[i] for i in next(order)], **kw)
    sync(device)

    rng = np.random.default_rng([seed, 3])
    check_at = set(int(i) for i in rng.choice(tr["check_within"], tr["check_batches"],
                                              replace=False))
    kept: dict[int, dict] = {}
    n_batch = [0]

    def capture(_module, _inputs, output):
        if n_batch[0] in check_at:
            kept[n_batch[0]] = {"y": output[0].detach().clone()}

    hook = yolo.model.register_forward_hook(capture)
    spans = Spans()
    lat, rows = [], 0
    setup_s = time.perf_counter() - t_start - calibrate_s
    print(f"set-up {setup_s:.2f} s, the reference's calibration {calibrate_s:.2f} s apart",
          file=sys.stderr)
    t0 = time.perf_counter()
    while True:
        idx = next(order)
        spans.begin("pb.predict")
        res = yolo.predict([pool[i] for i in idx], **kw)
        lat.append(spans.end("pb.predict"))
        rows += sum(len(r.boxes.data) for r in res)
        if n_batch[0] in kept:
            kept[n_batch[0]].update(idx=idx, results=res)
        n_batch[0] += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    spans.freeze()
    print(f"rows an image: {rows / (n_batch[0] * tr['batch']):.2f}", file=sys.stderr)
    quarters = [lat[k * len(lat) // 4:(k + 1) * len(lat) // 4] for k in range(4)]
    print("window quarters (median, p95 ms): " + ", ".join(  # the latencies' drift
        f"{1e3 * percentile(q, 50):.1f} {1e3 * percentile(q, 95):.1f}" for q in quarters if q),
        file=sys.stderr)
    hook.remove()
    n_window = n_batch[0]

    traced = None
    if trace:
        traced = traced_tail(yolo, pool, order, tr, kw, spans)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    images = n_window * tr["batch"]
    out = {"attempted": images, "window_s": window_s, "batches": n_window, "peak_bytes": peak,
           "spans": spans, "traced": traced,
           "e2e": {"serve_images_per_s": images / window_s,
                   "serve_batch_p95_ms": 1e3 * percentile(lat, 95),
                   "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    missing = sorted(check_at - set(kept))
    del yolo
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out["numbers"] = check(cfg, tr, seed, cls_bias, pool, kept, missing, device)
    out["checks"] = held(out["numbers"], cfg["limits"]["serve"])
    out["check_s"] = time.perf_counter() - t_check
    return out


def model_dict(cfg: dict) -> dict:
    import yaml

    with open(cfg["yaml_path"]) as f:
        d = yaml.safe_load(f)
    d["scale"] = cfg["scale"]
    d["yaml_file"] = cfg["yaml_path"]
    return d


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def traced_tail(yolo, pool, order, tr: dict, kw: dict, spans: Spans) -> dict:
    """``trace_batches`` more batches under the profiler; the candidates
    over conf an image (a hook's count on the card) and the rows kept, for
    K4's bound."""
    import torch

    valid, kept = [], []

    def count(_module, _inputs, output):
        valid.append((output[0][..., 4:].amax(-1) > tr["conf"]).sum(-1))

    hook = yolo.model.register_forward_hook(count)
    spans.tracing = True
    torch.cuda.synchronize()
    with Trace() as t:
        spans.begin(Trace.WINDOW)
        for _ in range(tr["trace_batches"]):
            spans.begin("pb.predict")
            res = yolo.predict([pool[i] for i in next(order)], **kw)
            spans.end("pb.predict")
            kept.extend(len(r.boxes.data) for r in res)
        torch.cuda.synchronize()
        spans.end(Trace.WINDOW)
    spans.tracing = False
    hook.remove()
    s = t.summary
    s["valid"] = [int(v) for v in torch.cat(valid).cpu()]
    s["kept"] = kept
    s["batches"] = tr["trace_batches"]
    s["images"] = tr["trace_batches"] * tr["batch"]
    return s


def check(*args) -> dict:
    """The compared numbers of ``_check``, the reference run with TF32 off."""
    from portbench.harness import tf32_off

    with tf32_off():
        return _check(*args)


def _check(cfg: dict, tr: dict, seed: int, cls_bias, pool, kept: dict, missing: list,
           device: str) -> dict:
    """The sampled batches against the reference: the head's largest box and
    score gaps and the count of rows that differ."""
    import torch

    from portbench.reference.model import build
    from portbench.reference.postprocess import nms, preprocess, scale_boxes
    from portbench.weights import make_state

    ref = build(cfg["yaml_path"], cfg["scale"], device=device)
    ref.load_state_dict(make_state(cfg, seed, device, cls_bias))
    ref.eval()
    box_gap = score_gap = rows_px = 0.0
    rows_differ = len(missing) * tr["batch"] * tr["max_det"]  # a batch never served
    with torch.no_grad():
        for b in sorted(kept):
            k = kept[b]
            imgs = [pool[i] for i in k["idx"]]
            x, metas = preprocess(imgs, cfg["imgsz"], device)
            y_ref = ref(x)[0].float()
            y = k["y"][: len(imgs)].float()
            box_gap = max(box_gap, (y[..., :4] - y_ref[..., :4]).abs().max().item())
            score_gap = max(score_gap, (y[..., 4:] - y_ref[..., 4:]).abs().max().item())
            rows, counts, _ = nms(y, tr["conf"], tr["iou"], tr["max_det"])
            res = k["results"]
            rows_differ += abs(len(res) - len(imgs)) * tr["max_det"]
            for j, (r, (ratio, pad), im) in enumerate(zip(res, metas, imgs)):
                want = rows[j, : int(counts[j])]
                want = torch.cat([scale_boxes(want[:, :4], ratio, pad, im.shape[:2]),
                                  want[:, 4:]], -1).cpu()
                got = torch.from_numpy(r.boxes.data[:, :6].astype(np.float32))
                n = min(len(got), len(want))
                rows_differ += abs(len(got) - len(want))
                box_px = (got[:n, :4] - want[:n, :4]).abs().amax(-1)
                rows_differ += int(((got[:n, 4:] != want[:n, 4:]).any(-1) | (box_px > ROW_PX)).sum())
                rows_px = max([rows_px, *box_px.tolist()])
    print(f"rows: largest box gap {rows_px!r} px", file=sys.stderr)
    return {"head_box_px": box_gap, "head_score": score_gap, "rows_differ": rows_differ}
